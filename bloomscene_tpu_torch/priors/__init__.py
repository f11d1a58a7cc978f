"""Pluggable generative priors: diffusion inpainting and monocular depth.

The port of ``bloomscene_tpu/priors/__init__.py``. The reference hard-wires
StableDiffusion-2-inpainting (fp16 + DDIM) and ZoeDepth-N from torch hub
(bloomscene.py:73-82, 89-138). Here they are protocols with two kinds of
implementation:

- ``Stub*Prior``: deterministic host numpy and scipy, bit for bit the JAX
  package's; they need no weights, so tests and machines without network
  run the whole pipeline with them.
- ``DiffusersInpaintPrior`` and ``ZoeDepthPrior``: adapters with lazy
  imports, used when the weights are on the machine; they run on
  ``device`` ("cuda" unless the caller asks for another).

Both kinds take and give numpy H x W x 3 float images in [0, 1].
"""
from __future__ import annotations

from typing import Protocol

import numpy as np


class InpaintPrior(Protocol):
    def __call__(self, image: np.ndarray, mask: np.ndarray, prompt: str,
                 negative_prompt: str = "", seed: int = 0,
                 num_steps: int = 50) -> np.ndarray:
        """Fill the mask == 1 regions of image; returns H x W x 3 float in
        [0, 1]."""
        ...


class DepthPrior(Protocol):
    def __call__(self, image: np.ndarray) -> np.ndarray:
        """Monocular depth; returns H x W float."""
        ...


def _to_uint8(image: np.ndarray) -> np.ndarray:
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


class StubInpaintPrior:
    """Deterministic inpainting stub: each hole pixel takes its nearest
    known pixel, smoothed inside the hole, plus low-frequency noise tied to
    the seed."""

    def __init__(self, iterations: int = 200):
        self.iterations = iterations

    def __call__(self, image, mask, prompt, negative_prompt="", seed=0,
                 num_steps: int = 50):
        from scipy.ndimage import distance_transform_edt, gaussian_filter
        img = np.array(image, np.float32)
        m = np.asarray(mask, np.float32)
        if m.ndim == 3:
            m = m[..., 0]
        hole = m > 0.5
        if not hole.any():
            return np.clip(img, 0, 1)
        idx = distance_transform_edt(hole, return_distances=False,
                                     return_indices=True)
        filled = img[idx[0], idx[1]]
        sm = gaussian_filter(filled, sigma=(9, 9, 0))
        out = np.where(hole[..., None], sm, img)
        rng = np.random.default_rng(seed)
        noise = gaussian_filter(
            rng.normal(0, 1, img.shape[:2]).astype(np.float32), 8)
        noise = noise / (np.abs(noise).max() + 1e-8) * 0.05
        out = out + hole[..., None] * noise[..., None]
        return np.clip(out, 0, 1)


class StubDepthPrior:
    """Deterministic monocular-depth stub: a smooth base depth modulated by
    luminance (dark pixels slightly farther), in an indoor range."""

    def __init__(self, base_depth: float = 2.5, amplitude: float = 0.8):
        self.base = base_depth
        self.amp = amplitude

    def __call__(self, image):
        from scipy.ndimage import gaussian_filter
        img = np.asarray(image, np.float32)
        lum = img.mean(-1)
        H, W = lum.shape
        yy, xx = np.mgrid[0:H, 0:W]
        r = np.sqrt(((xx - W / 2) / W) ** 2 + ((yy - H / 2) / H) ** 2)
        depth = self.base + self.amp * (0.5 - gaussian_filter(lum, 5)) \
            + 0.6 * r
        return np.clip(depth, 0.3, 12.0).astype(np.float32)


class DiffusersInpaintPrior:
    """StableDiffusion-2 inpainting through diffusers (the reference's
    prior, bloomscene.py:73-78, 89-134). Needs local weights. The pipeline
    takes PIL images, so PIL is imported here, and only here."""

    def __init__(self, model_id: str = "stabilityai/stable-diffusion-2-inpainting",
                 device: str = "cuda", dtype=None):
        import torch
        from diffusers import DDIMScheduler, StableDiffusionInpaintPipeline
        dtype = dtype or (torch.float16 if device != "cpu"
                          else torch.float32)
        self.pipe = StableDiffusionInpaintPipeline.from_pretrained(
            model_id, torch_dtype=dtype).to(device)
        self.pipe.scheduler = DDIMScheduler.from_config(
            self.pipe.scheduler.config)

    def __call__(self, image, mask, prompt, negative_prompt="", seed=0,
                 num_steps: int = 50):
        import torch
        from PIL import Image
        g = torch.Generator(device=self.pipe.device).manual_seed(seed)
        mk = np.asarray(mask)
        if mk.ndim == 3:
            mk = mk[..., 0]
        out = self.pipe(prompt=prompt, negative_prompt=negative_prompt,
                        image=Image.fromarray(_to_uint8(image)),
                        mask_image=Image.fromarray(_to_uint8(mk)),
                        generator=g, num_inference_steps=num_steps).images[0]
        return np.asarray(out, np.float32) / 255.0


class ZoeDepthPrior:
    """ZoeDepth-N monocular depth (the reference's prior, bloomscene.py:82).
    Needs local weights. ``infer_pil`` takes a PIL image, so PIL is
    imported here, and only here."""

    def __init__(self, repo: str = "isl-org/ZoeDepth", device: str = "cuda"):
        import torch
        self.model = torch.hub.load(repo, "ZoeD_N", pretrained=True)
        self.model = self.model.to(device).eval()

    def __call__(self, image):
        from PIL import Image
        return np.asarray(
            self.model.infer_pil(Image.fromarray(_to_uint8(image))),
            np.float32)
