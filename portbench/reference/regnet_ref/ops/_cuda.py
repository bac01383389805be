"""What the copied modules keep of the port's kernel loader: the count of
slab 3-NN fallbacks.  The reference launches no kernel: the copied modules
run their plain versions on every device."""

from collections import Counter

fallbacks = Counter()
fallbacks.add = lambda name: fallbacks.update([name])
