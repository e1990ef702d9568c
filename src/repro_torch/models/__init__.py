"""LM model substrate for the ten architectures: layers, attention with
KV caches, MoE, Mamba-2 SSD, the seven model families with their
training loss, and autoregressive generation with the KY token
sampler."""
