"""Replicate / Cog predictor of the port, counterpart of the root
``cog_predict.py`` (the reference's surface, cog_predict.py:8-59):
``setup()`` resolves the weights ``predict()`` uses and leaves them on the
device in the weights' model cache, ``predict()`` maps the web parameters
onto ``cgd_tpu_torch.api.clip_guided_diffusion`` (which finds them there, so
no call after ``setup()`` reads them again) and yields the frames' paths.
Import-guarded, so that the module works without the ``cog`` package (it
exists only inside the Replicate container).

It runs the 256px unconditional model with CLIP ViT-B/32 on ``device``
(the card, unless a caller sets ``device = "cpu"``); with an init image
the first half of the respaced steps is skipped (``skip = respace // 2``)
and the LPIPS init loss is on (``init_scale`` 1000).
"""

from pathlib import Path

try:
    from cog import BasePredictor, Input
    from cog import Path as CogPath
except ImportError:  # cog only exists inside the Replicate container
    CogPath = Path

    class BasePredictor:  # minimal stand-in with the same hook names
        def setup(self):
            pass

    def Input(default=None, **kw):  # noqa: N802 (cog API name)
        return default


class ClipGuidedDiffusionPredictor(BasePredictor):
    device = "cuda"
    weights_mode = "auto"  # "random": no checkpoints (tests, smoke runs)
    compute_dtype = "bfloat16"

    def setup(self):
        """Resolve (download and convert, once) the 256px unconditional
        checkpoint and ViT-B/32 as predict() runs them (its compute dtype's
        convs), and keep them on the device for it."""
        from cgd_tpu_torch.api import resolve_device, torch_dtype
        from cgd_tpu_torch.weights import resolve_clip, resolve_unet

        dev, conv_dtype = resolve_device(self.device), torch_dtype(self.compute_dtype)
        resolve_clip("ViT-B/32", self.weights_mode, dev, conv_dtype=conv_dtype)
        resolve_unet(256, class_cond=False, mode=self.weights_mode, device=dev,
                     conv_dtype=conv_dtype)

    def predict(
        self,
        prompt: str = Input(default="an impressionist painting of a lighthouse"),
        respace: str = Input(default="ddim50"),
        init_image: Path = Input(default=None),
        num_cutouts: int = Input(default=16),
        clip_guidance_scale: int = Input(default=1000),
        tv_scale: int = Input(default=150),
        range_scale: int = Input(default=50),
        seed: int = Input(default=0),
    ):
        from cgd_tpu_torch.api import clip_guided_diffusion

        skip = int(str(respace).replace("ddim", "")) // 2 if init_image else 0
        init_scale = 1000 if init_image else 0
        gen = clip_guided_diffusion(
            prompts=[prompt],
            image_size=256,
            class_cond=False,
            randomize_class=False,
            clip_model_name="ViT-B/32",
            timestep_respacing=str(respace),
            skip_timesteps=skip,
            init_image=str(init_image) if init_image else None,
            init_scale=init_scale,
            num_cutouts=num_cutouts,
            clip_guidance_scale=clip_guidance_scale,
            tv_scale=tv_scale,
            range_scale=range_scale,
            seed=seed,
            save_frequency=5,
            progress=False,
            device=self.device,
            weights_mode=self.weights_mode,
            compute_dtype=self.compute_dtype,
        )
        for _batch_idx, frame_path in gen:
            yield CogPath(frame_path)
