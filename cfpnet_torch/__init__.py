"""cfpnet_torch: the PyTorch/CUDA port of ``cfpnet_tpu``.

CFPNet depth completion: an RGB image and an 8x8 grid of ToF zone
histograms in, dense metric depth out. The JAX package ``cfpnet_tpu`` is
the reference this package is held against; this package imports nothing
of it. Eval forward of the production model: ``models.deltar``; entry points:
``python -m cfpnet_torch.evaluate`` and ``python -m cfpnet_torch.train``.
"""
