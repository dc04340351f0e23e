"""Feature exchange (counterpart of the JAX package's ``parallel/``). This
slice holds only the fp8 row codec of the host cold tier."""
