"""The device half of the port: the plain fp381 engine (limbs, towers,
points, h2c, pairing, verify stages), the CUDA kernels and their
wrappers (kernels/), and the provider."""
