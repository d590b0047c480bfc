"""Lane-batched rendering over a list of devices (port of
``phonic_tpu/parallel``)."""
