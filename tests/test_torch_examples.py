"""The port's examples stay runnable: ``tests/test_examples.py``'s tiny
sizes, ``--device cpu``, each in a process of its own."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import torch

from particlesystem_tpu_torch.examples import fountain_render

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _run(module, *args):
    proc = subprocess.run(
        [sys.executable, "-m", f"particlesystem_tpu_torch.examples.{module}",
         *args, "--device", "cpu"], cwd=REPO, env=ENV, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _read_png(path):
    """(width, height, pixels) of an 8-bit greyscale PNG of one IDAT."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    at, chunks = 8, {}
    while at < len(data):
        n, = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        crc, = struct.unpack(">I", data[at + 8 + n:at + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = body
        at += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 0)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, w + 1)
    assert not rows[:, 0].any()  # filter byte 0 on every row
    return w, h, rows[:, 1:]


def test_png_writer_round_trips(tmp_path):
    img = np.arange(6 * 5, dtype=np.uint8).reshape(6, 5) * 7
    fountain_render.write_png(str(tmp_path / "t.png"), img)
    w, h, px = _read_png(str(tmp_path / "t.png"))
    assert (w, h) == (5, 6)
    np.testing.assert_array_equal(px, img)


def test_fountain_render_example(tmp_path):
    out = _run("fountain_render", str(tmp_path), "12")
    assert "done:" in out
    pngs = sorted(p for p in os.listdir(tmp_path) if p.startswith("frame_"))
    assert pngs, out
    w, h, px = _read_png(str(tmp_path / pngs[-1]))
    assert (w, h) == (fountain_render.IMG, fountain_render.IMG)
    assert px.any()  # particles were drawn
    w, h, _ = _read_png(str(tmp_path / "contact_sheet.png"))
    assert w == fountain_render.SHEET_COLS * fountain_render.IMG // 2


def test_nbody_demo_example():
    out = _run("nbody_demo", "4000", "3")
    assert "final state" in out
    assert "iter 3: alive=" in out
    assert "chunk occupancy (4^3)" in out
    assert "phase step" in out
