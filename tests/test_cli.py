"""CLI driver tests (main.rs pipeline equivalence + flags)."""

import os
import struct
import subprocess
import sys

import numpy as np

from raytrace_tpu.io.bmp import read_bmp

from conftest import GOLDEN_SCENE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "raytrace_tpu.cli", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=520)


def test_cli_end_to_end(tmp_path):
    out = tmp_path / "render.bmp"
    r = _run([str(GOLDEN_SCENE), "-o", str(out),
              "--width", "16", "--height", "12", "--spp", "2", "-q"],
             cwd=REPO)
    assert r.returncode == 0, r.stderr
    img = read_bmp(str(out))
    assert img.shape == (12, 16, 3)
    assert img.max() > 0  # something rendered

    # the reference writer's 122-byte header (bmp.rs:10-61) at its
    # width-independent offsets
    blob = open(out, "rb").read()
    assert blob[:2] == b"BM"
    assert struct.unpack("<I", blob[10:14])[0] == 0x7A   # pixel offset
    assert struct.unpack("<I", blob[14:18])[0] == 0x6C   # DIB size
    assert struct.unpack("<HH", blob[26:30]) == (1, 24)  # planes + bpp
    assert blob[0x46:0x4A] == b"BGRs"
    w = struct.unpack("<i", blob[18:22])[0]
    assert w == 16


def test_cli_shard_flag_matches(tmp_path):
    a, b = tmp_path / "a.bmp", tmp_path / "b.bmp"
    common = [str(GOLDEN_SCENE), "--width", "8",
              "--height", "8", "--spp", "2", "--seed", "4", "-q"]
    r1 = _run([*common, "-o", str(a)], cwd=REPO)
    r2 = _run([*common, "-o", str(b), "--shard"], cwd=REPO)
    assert r1.returncode == 0, r1.stderr
    assert r2.returncode == 0, r2.stderr
    np.testing.assert_array_equal(read_bmp(str(a)), read_bmp(str(b)))


def test_cli_missing_scene_error(tmp_path):
    r = _run(["/nonexistent/scene.txt", "-o", str(tmp_path / "x.bmp")],
             cwd=REPO)
    assert r.returncode == 1
    assert "error:" in r.stderr


def test_cli_bad_scene_error(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("{ objects: [ } ")
    r = _run([str(bad), "-o", str(tmp_path / "x.bmp")], cwd=REPO)
    assert r.returncode == 1
    assert "error:" in r.stderr and ":" in r.stderr  # row:col shape


def test_cli_checkpoint_resume(tmp_path):
    out = tmp_path / "r.bmp"
    ck = tmp_path / "state.npz"
    common = [str(GOLDEN_SCENE), "--width", "8",
              "--height", "8", "--spp", "4", "--seed", "1", "-q",
              "--checkpoint", str(ck)]
    r1 = _run([*common, "-o", str(out)], cwd=REPO)
    assert r1.returncode == 0, r1.stderr
    ref_img = read_bmp(str(out))
    assert ck.exists()
    # resume from the finished checkpoint: must reproduce instantly
    r2 = _run([*common, "-o", str(out)], cwd=REPO)
    assert r2.returncode == 0, r2.stderr
    np.testing.assert_array_equal(read_bmp(str(out)), ref_img)
