"""Entry points of the port: ``steps`` (the step builders), ``serve``
(batched prefill, then decode), ``train``, the overlay's ``gpgpu_serve``
and ``gpgpu_compile``, and ``mesh`` (device meshes and the sharding
rules)."""
