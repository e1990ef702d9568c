"""Sharding of the port: how the serving engine splits its lanes over a
device mesh (:mod:`repro_torch.sharding.specs`)."""
