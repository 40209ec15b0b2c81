"""ray_tpu_torch.util — the collective API (``util.collective``), as in
the JAX package's ``ray_tpu.util``."""
