"""The plain reference of every configuration's model, in plain PyTorch.

It imports nothing of the program under test: the benchmark hands it the
same weights, tokens and latents, and it works everything else out again.
One module per denoiser family (``unet``, ``dit``) beside the shared text
tower, VAE decoder, transformer block and samplers.
"""
