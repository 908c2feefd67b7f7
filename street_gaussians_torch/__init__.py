"""PyTorch + CUDA port of street_gaussians_tpu for NVIDIA Hopper (H100).

Modules mirror the JAX package's paths and names. The port imports
torch, numpy and scipy only: never jax and never street_gaussians_tpu.
Entry points (serve.render_views, data.synthetic.make_synthetic_scene)
run on CUDA unless the caller passes a device; without CUDA they raise.
"""
