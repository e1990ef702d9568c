"""AIA core: threefry bit streams, fixed point, LUT interpolation and
non-normalized Knuth-Yao sampling, as plain PyTorch functions."""
