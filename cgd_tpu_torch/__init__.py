"""cgd_tpu_torch — the PyTorch / CUDA port of cgd_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``cgd_tpu``: the same CLIP-guided
sampling path (ADM UNet, CLIP ViT and ModifiedResNet, cutouts, their
augmentations and the losses, DDIM / ancestral / DPM-Solver++(2M) samplers,
the ``clip_guided_diffusion`` generator) in PyTorch, with the 3x3 conv
family and the attention as hand-written CUDA kernels for ``sm_90a``
(``cgd_tpu_torch/csrc``). It never imports jax.

    from cgd_tpu_torch.api import clip_guided_diffusion
    for batch_idx, frame_path in clip_guided_diffusion(prompts=["a photo"],
                                                       weights_mode="random"):
        ...
"""

__version__ = "0.1.0"
