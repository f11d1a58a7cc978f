"""No-reference quality metrics (reference utils/metrics.py:21-81).

The port of ``bloomscene_tpu/utils/metrics.py``. CLIP score, CLIP-IQA,
BRISQUE and NIQE need pretrained weights (CLIP ViT-B/16, pyiqa models)
that a machine without network cannot fetch: each returns NaN with
``available=False`` unless the packages and local weights are there.
``proxy_iqa`` (sharpness, colorfulness, contrast) needs nothing, so every
run gets some quality signal.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def proxy_iqa(images: Sequence[np.ndarray]) -> dict:
    """Dependency-free image statistics: laplacian sharpness, Hasler-
    Susstrunk colorfulness, RMS contrast."""
    sharp, colorful, contrast = [], [], []
    for im in images:
        im = np.asarray(im, np.float32)
        gray = im.mean(-1)
        lap = (-4 * gray
               + np.roll(gray, 1, 0) + np.roll(gray, -1, 0)
               + np.roll(gray, 1, 1) + np.roll(gray, -1, 1))
        sharp.append(float(lap.var()))
        rg = im[..., 0] - im[..., 1]
        yb = 0.5 * (im[..., 0] + im[..., 1]) - im[..., 2]
        colorful.append(float(np.sqrt(rg.std() ** 2 + yb.std() ** 2)
                              + 0.3 * np.sqrt(rg.mean() ** 2
                                              + yb.mean() ** 2)))
        contrast.append(float(gray.std()))
    return {
        'proxy_sharpness': float(np.mean(sharp)),
        'proxy_colorfulness': float(np.mean(colorful)),
        'proxy_contrast': float(np.mean(contrast)),
    }


def clip_score_and_iqa(images: Sequence[np.ndarray], prompt: str) -> dict:
    """CLIP ViT-B/16 prompt similarity (metrics.py:21-58); NaN when the
    weights are not on this machine."""
    out = {'clip_score': float('nan'), 'clip_iqa_quality': float('nan'),
           'clip_iqa_colorfulness': float('nan'),
           'clip_iqa_sharpness': float('nan'), 'available': False}
    try:
        import torch
        from transformers import CLIPModel, CLIPProcessor
        # fail fast when the weights are not cached locally
        kw = dict(local_files_only=True)
        model = CLIPModel.from_pretrained("openai/clip-vit-base-patch16",
                                          **kw)
        proc = CLIPProcessor.from_pretrained("openai/clip-vit-base-patch16",
                                             **kw)
        ims = [np.asarray(np.clip(im, 0, 1) * 255, np.uint8)
               for im in images]
        with torch.no_grad():
            inputs = proc(text=[prompt], images=ims, return_tensors="pt",
                          padding=True)
            res = model(**inputs)
            img_emb = res.image_embeds / res.image_embeds.norm(dim=-1,
                                                               keepdim=True)
            txt_emb = res.text_embeds / res.text_embeds.norm(dim=-1,
                                                             keepdim=True)
            out['clip_score'] = float((img_emb @ txt_emb.T).mean() * 100)
        out['available'] = True
    except Exception:   # no transformers, or no local weights
        pass
    return out


def brisque_and_niqe(images: Sequence[np.ndarray]) -> dict:
    """BRISQUE and NIQE through pyiqa (metrics.py:61-81); NaN when
    unavailable."""
    out = {'brisque': float('nan'), 'niqe': float('nan'),
           'available': False}
    try:
        import pyiqa
        import torch
        br = pyiqa.create_metric('brisque')
        nq = pyiqa.create_metric('niqe')
        t = torch.stack([
            torch.tensor(np.asarray(im, np.float32)).permute(2, 0, 1)
            for im in images])
        out['brisque'] = float(br(t).mean())
        out['niqe'] = float(nq(t).mean())
        out['available'] = True
    except Exception:   # no pyiqa, or no local weights
        pass
    return out


def evaluate_renders(images: Sequence[np.ndarray], prompt: str) -> dict:
    """The end-of-run metric bundle (run.py:109-111)."""
    out = proxy_iqa(images)
    out.update(clip_score_and_iqa(images, prompt))
    out.update(brisque_and_niqe(images))
    return out


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))
