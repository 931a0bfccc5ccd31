"""Twins of the repo's examples on the port: `dam_break`, `fit_material`
and `distributed_slab` (python -m dieselfluid_tpu_torch.examples.<name>
[--cpu])."""
