"""Train the KPN deraining network (port of
``da_detect_tpu/tools/train_derain.py``: EfficientDeRain's train.py,
trainer.py and validation.py).

Pairs rainy and clean images by file name from two directories (or
synthesizes rain on the fly over the clean images with the Garg-Nayar
overlay that built Rainy-Cityscapes, ``tools/generate_rainy_dataset.py``,
which needs cv2), random-crops to a fixed square, and runs one Adam step an
iteration (betas 0.5, 0.999). The loss is ``derain_loss`` (L2 plus the L1
of the image gradients' difference) with an optional 1 - SSIM term; the
learning rate stays constant for the first ``--lr-decrease-at`` of the
iterations, then falls linearly to 0 (optax's ``join_schedules`` of a
constant and a linear schedule, counted from the first update). Validation
reports PSNR and SSIM; ``kpn_final.npz`` holds the weights under the JAX
package's keys and layouts (``jax.tree_util.keystr`` paths, HWIO kernels).

    python -m da_detect_tpu_torch.tools.train_derain --clean-dir ... \
        [--rainy-dir ...] --iters 2000 --crop 224 --out ./derain_ckpt \
        [--device cpu]

Without ``--device cpu`` it needs a card. The model is ``KPN()`` in
float32, its weights drawn as Flax draws a conv's (truncated lecun normal,
biases 0) from ``--seed``.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from ..utils.logging_utils import setup_logger


def _load_pairs(clean_dir: str, rainy_dir: str | None, exts=(".png", ".jpg")):
    cleans = sorted(p for p in glob.glob(os.path.join(clean_dir, "**", "*"),
                                         recursive=True)
                    if p.lower().endswith(exts))
    if not cleans:
        raise FileNotFoundError(f"no images under {clean_dir}")
    if rainy_dir is None:
        return [(None, c) for c in cleans]
    pairs = []
    for c in cleans:
        r = os.path.join(rainy_dir, os.path.relpath(c, clean_dir))
        if os.path.exists(r):
            pairs.append((r, c))
    if not pairs:
        raise FileNotFoundError("no filename-aligned rainy/clean pairs")
    return pairs


def _read_unit(path: str) -> np.ndarray:
    from ..data.image_io import load_image_bgr
    return load_image_bgr(path)[..., ::-1].astype(np.float32) / 255.0


def _sample_batch(pairs, crop: int, batch: int, rng: np.random.RandomState):
    """(rainy, clean) float32 [batch, crop, crop, 3] RGB in [0, 1], drawn
    from ``rng`` in the JAX package's order (so both draw the same crops
    and rain from one seed)."""
    from .generate_rainy_dataset import rain_aug, synth_rain_mask
    rainy_b = np.empty((batch, crop, crop, 3), np.float32)
    clean_b = np.empty((batch, crop, crop, 3), np.float32)
    for i in range(batch):
        rp, cp = pairs[rng.randint(len(pairs))]
        clean = _read_unit(cp)
        rainy = _read_unit(rp) if rp is not None else None
        h, w = clean.shape[:2]
        if h < crop or w < crop:
            py, px = max(0, crop - h), max(0, crop - w)
            clean = np.pad(clean, ((0, py), (0, px), (0, 0)), mode="edge")
            if rainy is not None:
                rainy = np.pad(rainy, ((0, py), (0, px), (0, 0)),
                               mode="edge")
            h, w = clean.shape[:2]
        y = rng.randint(h - crop + 1)
        x = rng.randint(w - crop + 1)
        clean = clean[y:y + crop, x:x + crop]
        if rainy is None:
            mask = synth_rain_mask(crop, crop, rng)
            rainy = rain_aug((clean * 255).astype(np.uint8), mask) / 255.0
        else:
            rainy = rainy[y:y + crop, x:x + crop]
        rainy_b[i], clean_b[i] = rainy, clean
    return rainy_b, clean_b


def to_nchw(x: np.ndarray, device) -> torch.Tensor:
    """numpy [B, H, W, C] -> a contiguous float32 [B, C, H, W] on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).to(device)


def lr_schedule(lr: float, iters: int, decay_start: int):
    """The learning rate of the update after ``count`` updates: ``lr`` up to
    ``decay_start``, then linear to 0 over ``iters - decay_start`` updates
    (optax's ``join_schedules([constant_schedule(lr),
    linear_schedule(lr, 0, iters - decay_start)], [decay_start])``; a
    transition of 0 updates keeps ``lr``)."""
    steps = iters - decay_start

    def sched(count: int) -> float:
        if count < decay_start or steps <= 0:
            return lr
        c = min(max(count - decay_start, 0), steps)
        return lr * (1.0 - c / steps)

    return sched


def init_kpn(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Flax's default conv init: kernels truncated normal in (-2, 2)
    standard deviations with std sqrt(1 / fan_in) / 0.8796 (lecun normal),
    biases 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / .87962566103423978
                torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                            2 * std, generator=generator)
                m.bias.zero_()


def make_train_step(model, optimizer, ssim_weight: float, schedule):
    """step(rainy, clean) -> the loss (a tensor, not synchronized): one Adam
    update at ``schedule(updates made before it)``."""
    from ..models.derain import derain_loss
    from ..ops.ssim import ssim

    count = [0]

    def step(rainy, clean):
        for group in optimizer.param_groups:
            group["lr"] = schedule(count[0])
        optimizer.zero_grad(set_to_none=True)
        pred = model(rainy)
        loss = derain_loss(pred, clean)
        if ssim_weight:
            loss = loss + ssim_weight * (1.0 - ssim(pred, clean))
        loss.backward()
        optimizer.step()
        count[0] += 1
        return loss.detach()

    return step


def jax_params(model: torch.nn.Module) -> dict:
    """The model's weights under the JAX package's ``kpn_final.npz`` keys
    (``jax.tree_util.keystr`` of the Flax params' paths) and layouts."""
    out = {}
    for name, p in model.state_dict().items():
        *path, leaf = name.split(".")
        v = p.detach().cpu().float().numpy()
        if leaf == "weight":
            leaf, v = "kernel", v.transpose(2, 3, 1, 0)   # OIHW -> HWIO
        out["".join(f"['{k}']" for k in (*path, leaf))] = \
            np.ascontiguousarray(v)
    return out


def main(argv=None) -> dict:
    """Trains and writes ``kpn_final.npz``; returns the last loss, the
    last validation's PSNR and SSIM, the seconds of the loop and the
    checkpoint's path."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--clean-dir", required=True)
    ap.add_argument("--rainy-dir", default=None,
                    help="paired rainy images; omit to synthesize rain")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--lr-decrease-at", type=float, default=0.5,
                    help="fraction of iters after which LR decays linearly")
    ap.add_argument("--ssim-weight", type=float, default=0.0)
    ap.add_argument("--val-period", type=int, default=500)
    ap.add_argument("--log-period", type=int, default=20)
    ap.add_argument("--out", default="./derain_out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..entry import resolve_device
    from ..models.derain import KPN
    from ..ops.ssim import psnr, ssim
    from ..utils.env import reference_numerics

    device = resolve_device(args.device)
    if device.type == "cuda":
        reference_numerics()  # full float32 convolutions, as the JAX KPN
    os.makedirs(args.out, exist_ok=True)
    log = setup_logger("da_detect_tpu_torch.derain", args.out)
    pairs = _load_pairs(args.clean_dir, args.rainy_dir)
    n_val = max(1, min(8, len(pairs) // 10))
    val_pairs, train_pairs = pairs[:n_val], pairs[n_val:] or pairs
    log.info("%d train pairs, %d val pairs", len(train_pairs), len(val_pairs))

    rng = np.random.RandomState(args.seed)
    model = KPN()
    init_kpn(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device)

    decay_start = int(args.iters * args.lr_decrease_at)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.5, 0.999))  # reference betas
    step = make_train_step(model, optimizer, args.ssim_weight,
                           lr_schedule(args.lr, args.iters, decay_start))

    def validate():
        ps, ss = [], []
        vrng = np.random.RandomState(1234)
        with torch.no_grad():
            for _ in range(len(val_pairs)):
                rainy, clean = _sample_batch(val_pairs, args.crop, 1, vrng)
                pred = model(to_nchw(rainy, device))
                clean = to_nchw(clean, device)
                ps.append(float(psnr(pred, clean)))
                ss.append(float(ssim(pred, clean)))
        return float(np.mean(ps)), float(np.mean(ss))

    t0 = time.perf_counter()
    loss, p, s = None, None, None
    for it in range(1, args.iters + 1):
        rainy, clean = _sample_batch(train_pairs, args.crop, args.batch, rng)
        loss = step(to_nchw(rainy, device), to_nchw(clean, device))
        if it % args.log_period == 0:
            log.info("iter %d/%d loss %.4f (%.2f it/s)", it, args.iters,
                     float(loss), it / (time.perf_counter() - t0))
        if it % args.val_period == 0 or it == args.iters:
            p, s = validate()
            log.info("iter %d: val PSNR %.2f dB, SSIM %.4f", it, p, s)
    seconds = time.perf_counter() - t0

    out = os.path.join(args.out, "kpn_final.npz")
    np.savez(out, **jax_params(model))
    log.info("saved %s", out)
    return dict(loss=None if loss is None else float(loss), psnr=p, ssim=s,
                seconds=seconds, checkpoint=out)


if __name__ == "__main__":
    main()
