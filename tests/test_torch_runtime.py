"""The port's host runtime against the JAX package's: the host library
(``runtime/native`` over ``csrc/host/*.c``), PCD decoding
(``core/pcd_io``), the scan loader (``runtime/loader``), and
``utils/{profiling, plotio}``.

Bounds: none; the C and Python routes give byte-equal outputs, and equal
the JAX package's. The C packer's parallel header parsing is held to the
Python packer over many calls with 8 threads (its copy in the JAX package
tokenises with ``strtok`` and fails now and then there; none may fail
here). ``ScanStream`` on the CPU yields the ``load_scan_stack`` rows.
"""

import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

import jax.numpy as jnp  # noqa: E402

from toyslam_tpu.core import pcd_io as jpcd  # noqa: E402
from toyslam_tpu.runtime import loader as jloader  # noqa: E402
from toyslam_tpu.utils import plotio as jplotio  # noqa: E402
from toyslam_tpu.utils import profiling as jprofiling  # noqa: E402
from toyslam_tpu_torch.core import pcd_io  # noqa: E402
from toyslam_tpu_torch.runtime import loader, native  # noqa: E402
from toyslam_tpu_torch.utils import plotio, profiling  # noqa: E402

PKG = Path(native.__file__).resolve().parents[1]


def _lzf_literals(data: bytes) -> bytes:
    """A valid LZF stream of literal runs (ctrl < 32: ctrl + 1 bytes)."""
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i:i + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def _lzf_with_backrefs(rng, n=4000) -> tuple[bytes, bytes]:
    """(stream, expected): literal runs and back references (short ones
    and ones past 9 bytes, the 0xE0 length extension), overlapping
    included."""
    out, stream = bytearray(), bytearray()
    while len(out) < n:
        run = bytes(rng.integers(0, 256, int(rng.integers(1, 33)),
                                 dtype=np.uint8))
        stream.append(len(run) - 1)
        stream += run
        out += run
        length = int(rng.integers(3, 40))
        off = int(rng.integers(1, min(len(out), 8000) + 1))
        ref = len(out) - off
        if length - 2 < 7:
            stream.append(((length - 2) << 5) | ((off - 1) >> 8))
        else:
            stream.append((7 << 5) | ((off - 1) >> 8))
            stream.append(length - 2 - 7)
        stream.append((off - 1) & 0xFF)
        for k in range(length):
            out.append(out[ref + k])
    return bytes(stream), bytes(out)


def test_host_library_builds_into_the_port():
    lib = native.build()
    assert lib.parent == PKG / "_build" and lib.name.startswith(
        "libtoyslam_host_")
    assert lib == native.library_path() and lib.exists()
    assert all(s.parent == PKG / "csrc" / "host" for s in native.SOURCES)
    assert native.bz2_available()
    src = (PKG / "csrc" / "host" / "scanpack.c").read_text()
    assert "strtok(" not in src and "strtok_r(" in src


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.c"
    bad.write_text("int f(void) { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_lzf_matches_python_and_jax():
    rng = np.random.default_rng(0)
    data = bytes(range(25)) * 4
    assert native.lzf_decompress(_lzf_literals(data), len(data)) == data
    for _ in range(5):
        stream, want = _lzf_with_backrefs(rng)
        assert native.lzf_decompress(stream, len(want)) == want
        assert pcd_io._lzf_decompress(stream, len(want)) == want
        assert jpcd._lzf_decompress(stream, len(want)) == want
    with pytest.raises(ValueError):  # a back reference before the start
        native.lzf_decompress(bytes([0x20, 0x05]), 16)


def test_extract_xyzi():
    pts = np.random.default_rng(1).normal(size=(100, 6)).astype(np.float32)
    out = native.extract_xyzi(pts.tobytes(), 100, 24, 0, 4, 8, 20)
    np.testing.assert_array_equal(out, pts[:, [0, 1, 2, 5]])
    no_i = native.extract_xyzi(pts.tobytes(), 100, 24, 0, 4, 8, -1)
    assert (no_i[:, 3] == 0).all()
    with pytest.raises(ValueError):
        native.extract_xyzi(pts.tobytes()[:100], 100, 24, 0, 4, 8, 20)


def _compressed_pcd(path, pts):
    """binary_compressed PCD (field-major payload, literal-only LZF)."""
    soa = np.concatenate([pts[:, c].copy() for c in range(4)]).tobytes()
    lit = _lzf_literals(soa)
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z intensity\n"
              "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {len(pts)}\nDATA binary_compressed\n")
    with open(path, "wb") as fh:
        fh.write(header.encode())
        fh.write(np.uint32(len(lit)).tobytes())
        fh.write(np.uint32(len(soa)).tobytes())
        fh.write(lit)


def _pcd_set(d: Path, rng, n=700):
    """ascii, binary and binary_compressed PCDs of one cloud (a NaN point
    among them) plus a short xyz-only binary one."""
    pts = rng.normal(0, 10, (n, 4)).astype(np.float32)
    pts[5, 0] = np.nan
    files = [d / "cloud_0.pcd", d / "cloud_1.pcd", d / "cloud_2.pcd",
             d / "cloud_3.pcd"]
    pcd_io.write_pcd(files[0], pts, binary=False)
    pcd_io.write_pcd(files[1], pts, binary=True)
    _compressed_pcd(files[2], pts)
    pcd_io.write_pcd(files[3], pts[:50, :3])
    return files


def test_read_pcd_routes_match_jax(tmp_path):
    files = _pcd_set(tmp_path, np.random.default_rng(2))
    for f in files:
        want = jpcd.read_pcd(f)
        for nat in (True, False):
            got = pcd_io.read_pcd(f, native=nat)
            assert got.dtype == np.float32
            assert got.tobytes() == want.tobytes(), (f, nat)


@pytest.mark.parametrize("cap", [64, 1024])
def test_scan_stacks_match_python_and_jax(tmp_path, cap):
    """The C packer, the Python packer and the JAX package's loader give
    the same stack bytes (capacity below and above the clouds)."""
    files = _pcd_set(tmp_path, np.random.default_rng(3))
    x_n, m_n = loader.load_scan_stack(files, cap)
    x_p, m_p = loader.load_scan_stack(files, cap, native=False)
    x_j, m_j = jloader.load_scan_stack(files, cap)
    for x, m in ((x_p, m_p), (x_j, m_j)):
        assert x.tobytes() == x_n.tobytes() and m.tobytes() == m_n.tobytes()
    assert m_n.dtype == bool and not m_n[1, 5]
    assert int(m_n[3].sum()) == min(50, cap) - 1  # row 5 is NaN


def test_pack_scans_names_the_files_that_fail(tmp_path):
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z intensity\n"
              "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
              "WIDTH 100\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              "POINTS 100\nDATA binary_compressed\n").encode()
    bad = {
        "oversized_comp": header + np.uint32(10_000).tobytes()
        + np.uint32(1600).tobytes() + b"\x00" * 16,
        "truncated_header": header + b"\x00\x01",
        "short_uncomp": header + np.uint32(4).tobytes()
        + np.uint32(64).tobytes() + bytes([3]) + b"abcd",
        "no_xyz": b"FIELDS a b\nSIZE 4 4\nTYPE F F\nCOUNT 1 1\nPOINTS 1\n"
                  b"DATA binary\n" + b"\x00" * 8,
    }
    good = tmp_path / "good.pcd"
    pcd_io.write_pcd(good, np.zeros((3, 4), np.float32))
    files = [good]
    for name, blob in bad.items():
        (tmp_path / f"{name}.pcd").write_bytes(blob)
        files.append(tmp_path / f"{name}.pcd")
    files.append(tmp_path / "missing.pcd")
    with pytest.raises(ValueError) as err:
        loader.load_scan_stack(files, 128)
    for f in files[1:]:
        assert str(f) in str(err.value)
    assert str(good) not in str(err.value)
    for f in files[1:4]:
        with pytest.raises(ValueError):
            pcd_io.read_pcd(f)


def _wide_pcd(path, rng):
    """A binary PCD of 1-3 points whose header lists x, y, z, intensity
    and up to 28 extra fields in a random order."""
    extra = [f"extra_{i}" for i in range(int(rng.integers(0, 29)))]
    names = list(rng.permutation(["x", "y", "z", "intensity"] + extra))
    nf, n = len(names), int(rng.integers(1, 4))
    header = (f"# .PCD v0.7\nVERSION 0.7\nFIELDS {' '.join(names)}\n"
              f"SIZE {' '.join(['4'] * nf)}\nTYPE {' '.join(['F'] * nf)}\n"
              f"COUNT {' '.join(['1'] * nf)}\nWIDTH {n}\nHEIGHT 1\n"
              f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    path.write_bytes(header.encode()
                     + rng.normal(0, 5, (n, nf)).astype(np.float32).tobytes())


def race_files(d: Path, seed=4, n=64):
    """Small PCDs whose header lines all differ: the packer's workers
    parse headers most of the time, each a different layout."""
    rng = np.random.default_rng(seed)
    files = []
    for k in range(n):
        f = d / f"cloud_{k}.pcd"
        if k % 8 == 3:
            pcd_io.write_pcd(f, rng.normal(0, 5, (7, 4)).astype(np.float32),
                             binary=False)
        elif k % 8 == 5:
            _compressed_pcd(f, rng.normal(0, 5, (9, 4)).astype(np.float32))
        else:
            _wide_pcd(f, rng)
        files.append(f)
    return files


def test_pack_scans_parallel_headers_never_fail(tmp_path):
    """2000 calls of the C packer with 8 threads over 64 small PCDs of
    different header layouts: every call succeeds and equals the Python
    packer. (With strtok's shared cursor, the JAX package's copy fails or
    mixes up fields in about 3 calls of 1000 on these inputs.)"""
    files = race_files(tmp_path)
    want = loader.load_scan_stack(files, 8, native=False)
    for _ in range(2000):
        x, m = native.pack_scans(files, 8, 8)
        assert x.tobytes() == want[0].tobytes()
        assert m.tobytes() == want[1].tobytes()


def test_directory_watcher(tmp_path):
    w = loader.DirectoryWatcher(tmp_path)
    j = jloader.DirectoryWatcher(tmp_path)
    assert w.poll() == j.poll() == []
    pts = np.zeros((10, 4), np.float32)
    for k in (2, 10, 1):
        pcd_io.write_pcd(tmp_path / f"cloud_{k}.pcd", pts)
    fresh = w.poll()
    assert fresh == j.poll() and [p.stem for p in fresh] == [
        "cloud_1", "cloud_2", "cloud_10"]
    assert w.poll() == []
    pcd_io.write_pcd(tmp_path / "cloud_3.pcd", pts)
    assert [p.stem for p in w.poll()] == ["cloud_3"]


@pytest.mark.parametrize("native_route", [True, False])
@pytest.mark.parametrize("prefetch", [1, 3])
def test_scan_stream_cpu_yields_the_stack(tmp_path, native_route, prefetch):
    files = _pcd_set(tmp_path, np.random.default_rng(5), n=90)
    x_s, m_s = loader.load_scan_stack(files, 128)
    stream = loader.ScanStream(files, 128, device="cpu", prefetch=prefetch,
                               native=native_route)
    got = list(stream)
    assert len(got) == len(files)
    for k, (x, m) in enumerate(got):
        assert x.device.type == "cpu" and x.dtype == torch.float32
        assert m.dtype == torch.bool
        assert x.numpy().tobytes() == x_s[k].tobytes()
        assert torch.equal(m, torch.from_numpy(m_s[k]))
    assert stream.wait_s >= 0.0


def test_scan_stream_raises_a_decode_error(tmp_path):
    files = _pcd_set(tmp_path, np.random.default_rng(6), n=20)
    files.insert(2, tmp_path / "missing.pcd")
    stream = loader.ScanStream(files, 32, device="cpu")
    it = iter(stream)
    next(it), next(it)
    with pytest.raises(ValueError, match="missing.pcd"):
        next(it)


def test_scan_stream_stops_when_the_consumer_does(tmp_path):
    files = _pcd_set(tmp_path, np.random.default_rng(7), n=20) * 4
    stream = loader.ScanStream(files, 32, device="cpu", prefetch=1)
    for _ in stream:
        break
    stream.thread.join(timeout=10)
    assert not stream.thread.is_alive()


def test_stage_timer_matches_jax():
    timers = (profiling.StageTimer(), jprofiling.StageTimer())
    x = torch.ones(128)
    for t in timers:
        for _ in range(3):
            with t.stage("add", result_holder={"y": [x + 1]}):
                time.sleep(0.002)
        t.time("mul", lambda a: a * 2, x)
    a, b = (t.summary() for t in timers)
    assert a.keys() == b.keys() == {"add", "mul"}
    for name in a:
        assert a[name]["count"] == b[name]["count"]
    assert a["add"]["avg_ms"] >= 2.0
    assert (timers[0].scan_log_line(5, 1.234, 0.2045)
            == timers[1].scan_log_line(5, 1.234, 0.2045))


def test_bench_1x_10x_matches_jax():
    single, ten, out = profiling.bench_1x_10x(lambda a: a * 2,
                                              torch.ones(64))
    js, jt, jout = jprofiling.bench_1x_10x(lambda a: a * 2, jnp.ones((64,)))
    assert single > 0 and ten > 0 and js > 0 and jt > 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    nested = profiling.block_until_ready({"a": (out, [out]), "b": 3})
    assert nested["b"] == 3


@pytest.mark.parametrize("case", range(4))
def test_plotio_matches_jax(case):
    rng = np.random.default_rng(8 + case)
    A = rng.normal(size=(2, 2))
    cov = A @ A.T + 0.1 * np.eye(2)
    x, y, yaw = rng.normal(size=3)
    chi2 = float(rng.uniform(1, 6))
    assert (plotio.covariance_ellipse_2d(cov, chi2)
            == jplotio.covariance_ellipse_2d(cov, chi2))
    for fn, args in (
            ("ellipse_polyline", (x, y, 2.0, 1.0, yaw)),
            ("covariance_ellipse_polyline", (x, y, cov, chi2)),
            ("arrow_polyline", (x, y, yaw, 1.5, 0.2))):
        got, want = getattr(plotio, fn)(*args), getattr(jplotio, fn)(*args)
        assert got.tobytes() == np.asarray(want).tobytes(), fn
