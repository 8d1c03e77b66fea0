"""Models of the port: layers, attention, the paged KV pool, the
decoder-only LM (``transformer``), the ``Model`` front-end and the JAX
weight bridge (``weights``)."""
