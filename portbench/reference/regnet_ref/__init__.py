"""A frozen copy of the plain paths of the port's model, losses, trainer
and weight loader: every op runs its plain PyTorch version on every device
(the copied kernel branches are cut out), so on the card it computes what
the kernels compute, with PyTorch's own operations.  Train-mode BatchNorm
statistics on the card are summed in f64, as the port's statistics kernel
sums them (on the CPU in f32, as the port's CPU path).
Imports nothing of the port or of JAX."""
