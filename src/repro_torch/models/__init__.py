"""LM model substrate for the ten architectures (serving half): layers,
attention with KV caches, MoE, Mamba-2 SSD, the seven model families and
autoregressive generation with the KY token sampler."""
