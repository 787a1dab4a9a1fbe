"""Render-loop demo: a fountain scene to PNG frames through the readback
ring.

    python -m particlesystem_tpu_torch.examples.fountain_render \\
        [out_dir] [n_frames] [--device cpu]

Counterpart of the JAX package's ``examples/fountain_render.py``: BASELINE
config 5's shape in miniature (two emitters, gravity, wind and drag, a
ground plane and a sphere) with ``ParticleSystem.enable_readback``, so the
sim loop never waits for the "display" (here a PNG splatter).  Writes
``out_dir/frame_####.png`` every ``RENDER_EVERY`` sim frames and a contact
sheet of them, ``out_dir/contact_sheet.png``, and prints the ring's
published and dropped counts.  The PNGs are written with ``zlib`` and
``struct`` from the standard library.
"""

from __future__ import annotations

import argparse
import os
import struct
import tempfile
import zlib

import numpy as np

from ..api import ParticleSystem

RENDER_EVERY = 6          # sim frames per rendered frame
IMG = 512                 # output image side, pixels
EXTENT = 12.0             # world half-width of the view
SHEET_COLS = 4            # contact sheet: frames a row
SHEET_MAX = 16            # and at most this many, evenly spaced


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit greyscale PNG of ``img`` (rows top to bottom)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def splat(packed: np.ndarray):
    """(image, alive count): the alive particles' (x, y) projected into a
    brightness image, each weighted by its fade ``1 - age/life``."""
    x, y, age, life = packed[0], packed[1], packed[6], packed[7]
    alive = (age <= life) & (life > 0)
    fade = np.where(alive, 1.0 - age / np.maximum(life, 1e-6), 0.0)
    img, _, _ = np.histogram2d(
        y[alive], x[alive], bins=IMG,
        range=[[-1.0, 2 * EXTENT - 1.0], [-EXTENT, EXTENT]],
        weights=fade[alive])
    img = np.log1p(img[::-1])            # y up; log for dynamic range
    img = (img / max(img.max(), 1e-6) * 255).astype(np.uint8)
    return img, int(alive.sum())


def contact_sheet(frames, cols: int = SHEET_COLS) -> np.ndarray:
    """Frames halved and tiled ``cols`` to a row."""
    small = [f[::2, ::2] for f in frames]
    rows = -(-len(small) // cols)
    h, w = small[0].shape
    sheet = np.zeros((rows * h, cols * w), np.uint8)
    for i, f in enumerate(small):
        r, c = divmod(i, cols)
        sheet[r * h:(r + 1) * h, c * w:(c + 1) * w] = f
    return sheet


def fountain(device) -> ParticleSystem:
    return (ParticleSystem(capacity=200_000, dt=1 / 60,
                           gravity=(0.0, -9.8, 0.0), wind=(1.5, 0.0, 0.0),
                           drag=0.1, device=device)
            .add_emitter(pos=(0.0, 0.5, 0.0), direction=(0.0, 1.0, 0.0),
                         cone_angle=0.25, speed=12.0, rate=120_000.0,
                         life_min=1.5, life_max=3.0)
            .add_emitter(pos=(4.0, 0.5, 0.0), direction=(-0.3, 1.0, 0.0),
                         cone_angle=0.15, speed=9.0, rate=60_000.0,
                         life_min=1.0, life_max=2.0)
            .add_plane(point=(0, 0, 0), normal=(0, 1, 0),
                       restitution=0.55, friction=0.2)
            .add_sphere(center=(2.0, 3.0, 0.0), radius=1.0,
                        restitution=0.5, friction=0.1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="fountain_render")
    ap.add_argument("out_dir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "fountain_frames"))
    ap.add_argument("n_frames", nargs="?", type=int, default=240)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    ps = fountain(args.device)
    rb = ps.enable_readback(depth=3)     # publisher: sim never blocks on IO
    shape = (ps.packed().shape[0], ps.config.slots)

    images = []
    for f in range(0, args.n_frames, RENDER_EVERY):
        ps.step(RENDER_EVERY)            # publishes this batch's last frame
        host = rb.ring.pop(shape)        # and pushes the previous one
        if host is None:
            continue                     # ring empty: render skips, sim runs
        img, alive = splat(host)
        write_png(os.path.join(args.out_dir, f"frame_{len(images):04d}.png"),
                  img)
        images.append(img)
        if len(images) % 10 == 1:
            print(f"sim frame {f:4d}: alive={alive}  ring fill="
                  f"{rb.ring.fill()}", flush=True)
    rb.flush()
    if images:
        pick = np.linspace(0, len(images) - 1,
                           min(SHEET_MAX, len(images))).round().astype(int)
        write_png(os.path.join(args.out_dir, "contact_sheet.png"),
                  contact_sheet([images[i] for i in pick]))

    print(f"done: {len(images)} PNGs and a contact sheet in {args.out_dir}  "
          f"(published={rb.published} dropped={rb.dropped} "
          f"alive={ps.alive_count()})")


if __name__ == "__main__":
    main()
