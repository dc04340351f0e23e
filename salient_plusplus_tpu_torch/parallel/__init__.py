"""Multi-GPU layer (counterpart of the JAX package's ``parallel/``): the
process-group bootstrap (``mesh.py``), the feature exchange with its fp8
codec (``exchange.py``) and the data-parallel train and eval steps
(``spmd.py``)."""
