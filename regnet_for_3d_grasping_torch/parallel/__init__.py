"""Data parallelism over devices (JAX ``parallel/``): meshes of ranks,
shards and folded seeds (`mesh`), process groups and spawned ranks
(`launch`), and serving over one worker process per device (`infer`)."""
