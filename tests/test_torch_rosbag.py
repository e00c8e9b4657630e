"""The port's ROS bag layer (``runtime/{lz4f, rosbag}`` and the C bag
reader of ``csrc/host/bagpack.c``) against the JAX package's.

Bounds: none; everything here is equal byte for byte or value for value.
The LZ4 encoder, every message encoder and both bag writers give the JAX
package's bytes; each package reads the other's frames and bags to equal
results (``read_messages``, the four ``pack_bag_*``); the C reader's
stack equals the Python reader's; the hand-assembled wire fixtures of
``tests/test_wire_fixtures.py`` decode alike through both packages; the C
parsers survive ``tests/test_native_fuzz.py``'s mutation corpora and a
bounded hypothesis fuzz. The apps: a bag written by the JAX ``gnss_demo``
replays through the port's ``--bag`` to the JAX replay's CSV, character
for character; the JAX package reads the port's ``fusion_demo`` bag to the
port's arrays; ``mapping_demo --device cpu`` on a bag writes the pose
columns and map of the same scans read from a PCD directory.
"""

import csv
import struct
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite's workers share the cores

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
sys.path.insert(0, str(TESTS))

import test_lz4 as jlz4_test  # noqa: E402
import test_native_fuzz as jfuzz  # noqa: E402
import test_wire_fixtures as jwire  # noqa: E402

from toyslam_tpu.runtime import lz4f as jlz4f  # noqa: E402
from toyslam_tpu.runtime import rosbag as jbag  # noqa: E402
from toyslam_tpu_torch.core import pcd_io  # noqa: E402
from toyslam_tpu_torch.runtime import lz4f, native, rosbag  # noqa: E402

COMPRESSIONS = ("none", "bz2", "lz4")
PAYLOADS = jlz4_test._payloads(np.random.default_rng(42))


@pytest.mark.parametrize("k", range(len(PAYLOADS)))
def test_lz4_frames_match_jax(k):
    data = PAYLOADS[k]
    frame = lz4f.compress(data)
    assert frame == jlz4f.compress(data)
    assert lz4f.decompress(frame) == data
    assert jlz4f.decompress(frame) == data
    assert native.lz4f_decompress(frame, len(data)) == data


def test_xxh32_matches_jax():
    rng = np.random.default_rng(1)
    for n in list(range(40)) + [63, 64, 65, 1000]:
        blob = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for seed in (0, 1, 2 ** 32 - 1):
            assert lz4f._xxh32(blob, seed) == jlz4f._xxh32(blob, seed)


def test_lz4_decodes_every_format_feature():
    """tests/test_lz4.py's hand-built frames (stored blocks, content size,
    block and content checksums, skippable and back-to-back frames)."""
    rng = np.random.default_rng(2)
    data = bytes(rng.integers(0, 8, 3000, dtype=np.uint8))
    comp = jlz4f._compress_block(data)
    assert lz4f._compress_block(data) == comp
    frame = jlz4_test._frame
    cases = [
        (frame([(None, data)]), data),
        (frame([(comp, data)], flg=0x68, content_size=len(data)), data),
        (frame([(comp, data)], flg=0x70), data),
        (frame([(comp, data)], flg=0x64, content_checksum=True), data),
        (struct.pack("<II", 0x184D2A53, 7) + b"1234567"
         + frame([(None, data)]), data),
        (frame([(None, data)]) + frame([(comp, data)]), data + data),
    ]
    for blob, want in cases:
        assert lz4f.decompress(blob) == want == jlz4f.decompress(blob)
        assert native.lz4f_decompress(blob, len(want)) == want


def test_lz4_malformed_frames_rejected():
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(0, 8, 500, dtype=np.uint8))
    good = lz4f.compress(data)
    bad_magic = b"\x00\x00\x00\x00" + good[4:]
    bad_hc = good[:6] + bytes([good[6] ^ 0xFF]) + good[7:]
    truncated = good[: len(good) // 2]
    oob_match = jlz4_test._frame([(b"\x10aa\x05\x00\x00", b"")])
    for blob in (bad_magic, bad_hc, truncated, oob_match):
        with pytest.raises(lz4f.LZ4Error):
            lz4f.decompress(blob)
        with pytest.raises(ValueError):
            native.lz4f_decompress(blob, 4096)
    with pytest.raises(ValueError):  # overflow errors, never truncates
        native.lz4f_decompress(good, len(data) - 1)


def _encoded(m, name):
    """Message ``name`` encoded by package ``m`` from seeded draws."""
    rng = np.random.default_rng(4)
    if name == "pointcloud2":
        pts = rng.normal(0, 5, (37, 4)).astype(np.float32)
        return m.encode_pointcloud2(pts, 1234.5678, "lidar")
    if name == "imu":
        return m.encode_imu(1234.5678, rng.normal(0, 1, 3),
                            rng.normal(0, 1, 3), [0.1, 0.2, 0.3, 0.9])
    if name == "navsatfix":
        return m.encode_navsatfix(99.25, 22.3045, 114.1797, 5.5, status=1)
    if name == "inspvax":
        return m.encode_inspvax(2156, 111_600_000, 22.3, 114.18, 3.0,
                                vn=1.0, ve=-2.0, vu=0.5, roll=1.5,
                                pitch=-0.5, azimuth=270.0)
    return m.encode_gnss_meas(2156, 345600.0, [3, 7, 12, 30],
                              2.0e7 + rng.normal(0, 1e4, 4),
                              [45.0, 38.0, 41.0, 50.0], rng.normal(0, 1, 4),
                              stamp_sec=345600.25)


def _same(a, b):
    """Equal values through nested dicts, lists and arrays (NaN == NaN)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b, equal_nan=True))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", ["pointcloud2", "imu", "navsatfix",
                                  "inspvax", "gnss_meas"])
def test_encoders_and_decoders_match_jax(name):
    raw = _encoded(rosbag, name)
    assert raw == _encoded(jbag, name)
    dec = f"decode_{name}"
    assert _same(getattr(rosbag, dec)(raw), getattr(jbag, dec)(raw))


def _mixed_records(m, rng):
    """Scans, 200 Hz IMU, INSPVAX, NavSatFix and GnssMeas on one bag (the
    reference's uwb_imu_batch + gnssSpp input graph), encoded by ``m``."""
    records = []
    for i in range(3):
        pts = rng.normal(0, 5, (90 + 7 * i, 4)).astype(np.float32)
        pts[3, 1] = np.nan
        records.append(("/velodyne_points", "sensor_msgs/PointCloud2",
                        10.0 + 0.1 * i, m.encode_pointcloud2(pts,
                                                             10.0 + 0.1 * i)))
    for i in range(40):
        t = 10.0 + i * 0.005
        records.append(("/imu/data", "sensor_msgs/Imu", t,
                        m.encode_imu(t, [0.0, 0.0, 0.01 * i],
                                     [0.1, 0.0, 9.81])))
    for i in range(3):
        records.append(("/novatel_data/inspvax", "novatel_msgs/INSPVAX",
                        10.0 + i, m.encode_inspvax(
                            2156, 111_600_000 + 1000 * i, 22.30 + 1e-5 * i,
                            114.18, 3.0, vn=1.0, vu=0.25)))
        records.append(("/fix", "sensor_msgs/NavSatFix", 10.0 + i,
                        m.encode_navsatfix(10.0 + i, 22.3 + 1e-5 * i, 114.18,
                                           4.0)))
        records.append(("/ublox_driver/range_meas", "gnss_comm/GnssMeasMsg",
                        10.0 + i, m.encode_gnss_meas(
                            2156, 345600.0 + i, [3, 7, 9][:i + 1],
                            [2.0e7, 2.1e7, 2.2e7][:i + 1])))
    return sorted(records, key=lambda r: r[2])


def _read_all(m, bag, **kw):
    """Every reader of package ``m`` over ``bag``."""
    out = {"messages": [(tp, t, ty, bytes(raw))
                        for tp, t, ty, raw in m.read_messages(bag)],
           "scans": m.pack_bag_scans(bag, capacity=96, **kw),
           "imu": m.pack_bag_imu(bag),
           "gps": m.pack_bag_gps(bag),
           "navsat": m.pack_bag_gps(bag, topic="/fix"),
           "gnss": m.pack_bag_gnss_meas(bag)}
    return out


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_bags_match_jax_and_cross_packages(tmp_path, comp):
    """Both writers give byte-equal bags (mixed topics, and scans through
    write_bag); each package reads either bag to equal results, the port
    through its C reader and its Python reader."""
    for name, m in (("port", rosbag), ("jax", jbag)):
        m.write_mixed_bag(tmp_path / f"{name}.bag",
                          _mixed_records(m, np.random.default_rng(5)),
                          compression=comp)
        rng = np.random.default_rng(6)
        m.write_bag(tmp_path / f"{name}_scans.bag",
                    [(0.5 * i, rng.normal(0, 9, (50, 4)).astype(np.float32))
                     for i in range(4)], compression=comp)
    for stem in ("", "_scans"):
        assert ((tmp_path / f"port{stem}.bag").read_bytes()
                == (tmp_path / f"jax{stem}.bag").read_bytes())
    bag = tmp_path / "jax.bag"
    want = _read_all(jbag, bag)
    assert len(want["scans"][2]) == 3 and len(want["gnss"]) == 3
    for kw in ({"native": True}, {"native": False}):
        assert _same(_read_all(rosbag, bag, **kw), want), kw
    assert _same(_read_all(jbag, tmp_path / "port.bag"), want)


def _both(name):
    """A decoder that runs both packages' and requires equal output."""

    def decode(raw):
        got = getattr(rosbag, name)(raw)
        assert _same(got, getattr(jbag, name)(raw)), name
        return got

    return decode


WIRE = sorted(n for n in dir(jwire) if n.startswith("test_"))


@pytest.mark.parametrize("fixture", WIRE)
def test_wire_fixtures_decode_alike(fixture, monkeypatch):
    """Each of tests/test_wire_fixtures.py's hand-assembled messages,
    decoded by both packages to equal values that pass its assertions."""
    shim = SimpleNamespace(**{n: _both(n) for n in dir(rosbag)
                              if n.startswith("decode_")})
    monkeypatch.setattr(jwire, "rosbag", shim)
    getattr(jwire, fixture)()


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_native_bag_pack_matches_python(tmp_path, comp):
    """The C reader against the Python reader: NaN points, a scan past
    the capacity, off-topic messages, counts, times; byte-equal."""
    rng = np.random.default_rng(7)
    scans = [(100.0 + 0.1 * i,
              rng.normal(0, 10, (200 + 30 * i, 4)).astype(np.float32))
             for i in range(4)]
    scans[1][1][7, 2] = np.nan
    cap = 256  # scan 3 has 290 points
    bag = tmp_path / f"scans_{comp}.bag"
    rosbag.write_bag(bag, scans, compression=comp)
    blob = bag.read_bytes()
    assert native.bag_count_scans(blob, "/velodyne_points") == 4
    nat = rosbag.pack_bag_scans(bag, capacity=cap)
    py = rosbag.pack_bag_scans(bag, capacity=cap, native=False)
    for a, b in zip(nat, py):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert nat[3][3] == cap and not nat[1][1, 7]
    with_max = rosbag.pack_bag_scans(bag, capacity=cap, max_scans=2)
    assert all(a.tobytes() == b[:2].tobytes() for a, b in zip(with_max, nat))

    other = tmp_path / "other.bag"
    rosbag.write_bag(other, scans[:2], topic="/other_points",
                     compression=comp)
    assert rosbag.pack_bag_scans(other, capacity=cap)[0].shape == (0, cap, 4)
    for bad in (blob[:40], blob[:-10],
                blob[:20] + b"\xff\xff\xff\xff" + blob[24:]):
        with pytest.raises(ValueError):
            native.bag_pack_scans(bad, "/velodyne_points", 4, cap)


def test_bz2_chunk_without_libbz2_names_bz2(monkeypatch):
    """Where libbz2 cannot be opened the C reader returns its own code for
    a bz2 chunk; the binding raises a ValueError that names bz2."""
    fake = SimpleNamespace(bag_pack_scans=lambda *a: -3)
    monkeypatch.setattr(native, "load", lambda: fake)
    with pytest.raises(ValueError, match="bz2"):
        native.bag_pack_scans(b"", "/velodyne_points", 1, 8)
    monkeypatch.undo()
    assert native.bz2_available()


@pytest.fixture(scope="module")
def bag_bytes(tmp_path_factory):
    rng = np.random.default_rng(0)
    scans = [(10.0 + i, rng.normal(0, 5, (150, 4)).astype(np.float32))
             for i in range(3)]
    p = tmp_path_factory.mktemp("fuzz") / "scans.bag"
    rosbag.write_bag(p, scans, compression="bz2")
    return p.read_bytes()


def _bag_outcome(blob):
    """'parsed' or 'failed'; a parse must stay inside its buffers."""
    try:
        xyzi, mask, times, counts, n = native.bag_pack_scans(
            blob, "/velodyne_points", 4, 256)
    except ValueError:
        return "failed"
    assert 0 <= n <= 4 and ((counts[:n] >= 0) & (counts[:n] <= 256)).all()
    return "parsed"


def test_native_bag_parser_mutation_corpus(bag_bytes):
    """tests/test_native_fuzz.py's deterministic corpus (truncations, byte
    flips, u32 stomps) through the port's C reader."""
    outcomes = [_bag_outcome(b) for b in jfuzz._mutants(
        np.random.default_rng(42), bag_bytes)]
    assert "failed" in outcomes and "parsed" in outcomes


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_native_bag_parser_fuzz(bag_bytes, data):
    n = len(bag_bytes)
    b = bytearray(bag_bytes)
    kind = data.draw(st.sampled_from(("truncate", "flip", "stomp")))
    if kind == "truncate":
        b = b[:data.draw(st.integers(0, n - 1))]
    elif kind == "flip":
        for at in data.draw(st.lists(st.integers(0, n - 1), min_size=1,
                                     max_size=8)):
            b[at] ^= data.draw(st.integers(1, 255))
    else:
        at = data.draw(st.integers(0, n - 4))
        b[at:at + 4] = data.draw(st.integers(0, 2 ** 32 - 1)).to_bytes(
            4, "little")
    _bag_outcome(bytes(b))


def test_bag_parser_rejects_overflowing_point_count(tmp_path):
    """height * width * point_step crafted to wrap int64 must be refused
    (tests/test_native_fuzz.py's case)."""
    pts = np.random.default_rng(5).normal(0, 5, (8, 4)).astype(np.float32)
    p = tmp_path / "evil.bag"
    rosbag.write_bag(p, [(1.0, pts)])
    blob = bytearray(p.read_bytes())
    anchor = struct.pack("<I", 8) + b"velodyne"
    hw = bytes(blob).find(anchor) + len(anchor)
    blob[hw:hw + 8] = struct.pack("<II", 1 << 17, 1 << 16)
    ps = hw + 8 + 4 + sum(4 + len(nm) + 9 for nm in (b"x", b"y", b"z",
                                                     b"intensity")) + 1
    assert struct.unpack_from("<I", blob, ps)[0] == 16
    blob[ps:ps + 4] = struct.pack("<I", 1 << 31)
    with pytest.raises(ValueError):
        native.bag_pack_scans(bytes(blob), "/velodyne_points", 4, 64)


def test_python_bag_reader_fails_loudly(bag_bytes, tmp_path):
    p = tmp_path / "m.bag"
    for blob in jfuzz._mutants(np.random.default_rng(43), bag_bytes):
        p.write_bytes(blob)
        try:
            list(rosbag.read_pointclouds(p))
        except (ValueError, struct.error, KeyError, EOFError, OSError):
            pass


@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_native_pcd_parser_fuzz(tmp_path, data):
    """Mutated binary PCDs through the C packer: a file either packs to
    the layout or is named in a ValueError, never a crash."""
    rng = np.random.default_rng(8)
    good = tmp_path / "good.pcd"
    if not good.exists():
        pcd_io.write_pcd(good, rng.normal(0, 5, (200, 4)).astype(np.float32))
    b = bytearray(good.read_bytes())
    for at in data.draw(st.lists(st.integers(0, len(b) - 1), min_size=1,
                                 max_size=6)):
        b[at] ^= data.draw(st.integers(1, 255))
    b = b[:data.draw(st.integers(1, len(b)))]
    p = tmp_path / "m.pcd"
    p.write_bytes(bytes(b))
    try:
        xyzi, mask = native.pack_scans([p], capacity=256)
    except ValueError as e:
        assert str(p) in str(e)
        return
    assert xyzi.shape == (1, 256, 4) and mask.shape == (1, 256)


def _run(*cli, cwd=REPO):
    proc = subprocess.run([sys.executable, *map(str, cli)],
                          capture_output=True, text=True, timeout=600,
                          cwd=cwd)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_gnss_demo_replays_jax_bag_to_jax_csv(tmp_path):
    """The JAX app writes an 8-epoch GnssMeasMsg bag and replays it (one
    process); the port's ``--bag --device cpu`` on that bag writes the JAX
    replay's gnss_position.csv to its printed digits, and its own
    simulation and replay solve to equal ENU positions."""
    from toyslam_tpu_torch.apps import gnss_demo

    bag = tmp_path / "meas.bag"
    _run("-c", f"""
import sys
sys.path.insert(0, {str(REPO / 'apps')!r})
import gnss_demo
assert gnss_demo.main([{str(tmp_path / 'jsim')!r}, '--epochs', '8',
                       '--write-bag', {str(bag)!r}]) == 0
assert gnss_demo.main([{str(tmp_path / 'jrep')!r}, '--epochs', '8',
                       '--bag', {str(bag)!r}]) == 0
""")
    assert gnss_demo.main([str(tmp_path / "rep"), "--epochs", "8",
                           "--device", "cpu", "--bag", str(bag)]) == 0
    assert ((tmp_path / "rep" / "gnss_position.csv").read_text()
            == (tmp_path / "jrep" / "gnss_position.csv").read_text())
    own = tmp_path / "own.bag"
    assert gnss_demo.main([str(tmp_path / "sim"), "--epochs", "8",
                           "--device", "cpu", "--write-bag", str(own)]) == 0
    assert gnss_demo.main([str(tmp_path / "orep"), "--epochs", "8",
                           "--device", "cpu", "--bag", str(own)]) == 0

    def enu(d):
        rows = csv.DictReader(open(tmp_path / d / "gnss_position.csv"))
        return [(r["enu_e"], r["enu_n"], r["enu_u"]) for r in rows]

    assert enu("sim") == enu("orep")
    assert len(jbag.pack_bag_gnss_meas(own)) == 8


def test_gnss_bag_local_solve_equals_simulation(tmp_path):
    """The card's route (f64 prep, f32 local solve) run on the host: the
    epochs read back from the bag solve to the simulation's positions bit
    for bit (only the range rates pass through -rr / lambda * lambda)."""
    from toyslam_tpu_torch.apps import gnss_demo
    from toyslam_tpu_torch.gnss import local, pipeline

    cpu = torch.device("cpu")
    store, iono, ch, ref, _, _ = gnss_demo.simulate(8, 24, 1.5, 0, 1.5, cpu)
    bag = tmp_path / "m.bag"
    gnss_demo.write_meas_bag(bag, ch)
    ch2, _ = gnss_demo.read_meas_bag(bag, 24, cpu)
    v = ch[5]
    assert torch.equal(ch2[5], v) and torch.equal(ch2[0], ch[0])
    assert torch.equal(ch2[2][v], ch[2][v]) and torch.equal(ch2[4][v], ch[4][v])
    cfg = pipeline.EpochConfig(apply_iono_correction=False)
    a, b = (local.solve_epochs_local(local.prep_epochs(
        store, iono, *c, ref, config=cfg), cfg) for c in (ch, ch2))
    assert torch.equal(a.enu, b.enu) and torch.equal(a.delta, b.delta)


def test_fusion_demo_bag_read_by_jax(tmp_path, capsys):
    """The port's ``fusion_demo --write-bag`` (Imu + INSPVAX, lz4) reads to
    equal arrays through both packages, and its replay passes
    tests/test_apps.py's gate (smoothed vs raw fixes < 0.5 m)."""
    from toyslam_tpu_torch.apps import fusion_demo

    bag = tmp_path / "sensors.bag"
    assert fusion_demo.main([str(tmp_path / "sim"), "--device", "cpu",
                             "--duration", "5", "--write-bag",
                             str(bag)]) == 0
    for fn in ("pack_bag_imu", "pack_bag_gps"):
        assert _same(getattr(rosbag, fn)(bag), getattr(jbag, fn)(bag)), fn
    t_imu = rosbag.pack_bag_imu(bag)[0]
    assert len(t_imu) == 1000 and len(rosbag.pack_bag_gps(bag)[0]) == 20
    capsys.readouterr()
    assert fusion_demo.main([str(tmp_path / "rep"), "--device", "cpu",
                             "--bag", str(bag)]) == 0
    out = capsys.readouterr().out
    assert "20 GPS keyframes" in out
    rmse = float(out.split("smoothed vs raw-fix RMSE:")[1].split()[0])
    assert rmse < 0.5, out
    assert (tmp_path / "rep" / "trajectory.txt").exists()


def test_mapping_demo_bag_equals_directory(tmp_path):
    """mapping_demo on a bag of five scans and on the same scans as PCDs:
    equal pose columns, map.pcd and convergence; times from the stamps."""
    from toyslam_tpu_torch.apps import mapping_demo
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    xyzi, mask, _ = spinning_lidar_scans(0, 5, 16, 512)
    (tmp_path / "scans").mkdir()
    for k in range(5):
        pcd_io.write_pcd(tmp_path / "scans" / f"cloud_{k}.pcd",
                         xyzi[k][mask[k]])
    rosbag.write_bag(tmp_path / "scans.bag",
                     [(50.0 + 0.1 * k, xyzi[k][mask[k]]) for k in range(5)],
                     compression="lz4")
    common = ["--device", "cpu", "--capacity", "8192", "--map-capacity",
              "8192"]
    for src, out in (("scans", "dir"), ("scans.bag", "bag")):
        assert mapping_demo.main([str(tmp_path / src), str(tmp_path / out),
                                  *common]) == 0
    tum = {d: np.loadtxt(tmp_path / d / "trajectory.txt") for d in
           ("dir", "bag")}
    assert np.array_equal(tum["dir"][:, 1:], tum["bag"][:, 1:])
    np.testing.assert_allclose(tum["bag"][:, 0], 50.0 + 0.1 * np.arange(5))
    assert ((tmp_path / "dir" / "map.pcd").read_bytes()
            == (tmp_path / "bag" / "map.pcd").read_bytes())
