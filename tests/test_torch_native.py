"""The port's host C++ ops (sbsim_tpu_torch/native) against the JAX
package's and against scipy, on the CPU.

* 4-connected labels, the exact Euclidean distance transform (within 1e-5)
  and the cross dilation of seeded random rasters: the port equals the JAX
  package's native ops, and both equal scipy.ndimage.
* process_floor_plan, now on the native ops, equals the JAX package's on
  the sb1 plan, the 126-room plan and its transpose, field for field.
* Shards written by either package read back equal through the other's
  reader; a truncated shard raises IOError, in its header or its payload.
* The build: the library lies under sbsim_tpu_torch/_build/, a failed build
  raises RuntimeError with no fallback, and four processes that build at
  once into an empty build directory all load a working library.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import ndimage

from sbsim_tpu import native as jnative
from sbsim_tpu.core import floorplan as jfloorplan
from sbsim_tpu.core import geometry as jgeo
from sbsim_tpu.io import records as jrecords
from sbsim_tpu.proto import building_pb2 as jbuilding
from sbsim_tpu_torch import native as tnative
from sbsim_tpu_torch.core import floorplan as tfloorplan
from sbsim_tpu_torch.io import records as trecords
from sbsim_tpu_torch.proto import building_pb2 as tbuilding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDT_ATOL = 1e-5
CROSS = ndimage.generate_binary_structure(2, 1)


def _raster(seed, shape, fill):
    return np.random.default_rng(seed).random(shape) < fill


RASTERS = [(0, (40, 37), 0.5), (1, (17, 64), 0.8), (2, (1, 9), 0.5), (3, (52, 67), 0.95)]


@pytest.mark.parametrize("seed,shape,fill", RASTERS)
def test_connected_components_equal_jax_and_scipy(seed, shape, fill):
    img = _raster(seed, shape, fill)
    got = tnative.connected_components_4(img)
    want, _ = ndimage.label(img, structure=CROSS)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jnative.connected_components_4(img))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,shape,fill", RASTERS)
def test_distance_transform_equals_jax_and_scipy(seed, shape, fill):
    img = _raster(seed, shape, fill)
    got = tnative.distance_transform_edt(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.distance_transform_edt(img))
    np.testing.assert_allclose(got, ndimage.distance_transform_edt(img), atol=EDT_ATOL, rtol=0)


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("seed,shape,fill", RASTERS)
def test_binary_dilation_equals_jax_and_scipy(seed, shape, fill, iterations):
    img = _raster(seed, shape, 1.0 - fill)  # sparse, so dilation has room to grow
    got = tnative.binary_dilation_cross(img, iterations=iterations)
    want = img.copy()
    for _ in range(iterations):
        want = ndimage.binary_dilation(want, structure=CROSS)
    np.testing.assert_array_equal(got, jnative.binary_dilation_cross(img, iterations))
    np.testing.assert_array_equal(got, want)


PLANS = {
    "sb1": lambda: jgeo.make_synthetic_office_plan(3, 4, room_cvs=14),
    "126room": lambda: jgeo.make_synthetic_office_plan(9, 14, room_cvs=12),
    "126room_transposed": lambda: jgeo.make_synthetic_office_plan(9, 14, room_cvs=12).T,
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_process_floor_plan_equals_jax(name):
    plan = np.ascontiguousarray(PLANS[name]())
    got = tfloorplan.process_floor_plan(plan)
    want = jfloorplan.process_floor_plan(plan)
    for field in ("floor_plan", "exterior_space", "exterior_walls", "interior_walls",
                  "interior_walls_initial", "room_labels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.room_dict == want.room_dict
    diffusers = dict(interior_walls=got.interior_walls_initial, buffer_from_walls=2)
    np.testing.assert_array_equal(
        tfloorplan.assign_thermal_diffusers(got.floor_plan.shape, got.room_dict, **diffusers),
        jfloorplan.assign_thermal_diffusers(want.floor_plan.shape, want.room_dict, **diffusers))


def _device_infos(pb2, n):
    return [pb2.DeviceInfo(device_id=f"vav_{i}", namespace="ns", code=f"code{i}" * i,
                           zone_id=f"zone_{i}", device_type=pb2.DeviceInfo.VAV)
            for i in range(n)]


def test_shards_cross_read_between_packages(tmp_path):
    """Records written by either package (and by the native appender) read
    back equal through both readers."""
    tmsgs, jmsgs = _device_infos(tbuilding, 5), _device_infos(jbuilding, 5)
    assert [m.SerializeToString() for m in tmsgs] == [
        m.SerializeToString(deterministic=True) for m in jmsgs]
    by_port, by_jax, by_native = (str(tmp_path / n) for n in ("port", "jax", "native"))
    trecords.append_records(by_port, tmsgs[:2])
    trecords.append_records(by_port, tmsgs[2:])
    jrecords.append_records(by_jax, jmsgs)
    tnative.append_record_payloads(by_native, [m.SerializeToString() for m in tmsgs[:3]])
    tnative.append_record_payloads(by_native, [m.SerializeToString() for m in tmsgs[3:]])
    assert open(by_port, "rb").read() == open(by_jax, "rb").read() == open(by_native, "rb").read()
    for path in (by_port, by_jax, by_native):
        assert list(trecords.read_records(path, tbuilding.DeviceInfo)) == tmsgs
        assert list(jrecords.read_records(path, jbuilding.DeviceInfo)) == jmsgs
        assert tnative.read_record_payloads(path) == jnative.read_record_payloads(path)
    empty = str(tmp_path / "empty")
    open(empty, "wb").close()
    assert tnative.read_record_payloads(empty) == []
    assert list(trecords.read_records(empty, tbuilding.DeviceInfo)) == []


@pytest.mark.parametrize("cut", [2, 7], ids=["in_the_length", "in_the_payload"])
def test_truncated_shard_raises(tmp_path, cut):
    """A shard whose last record is cut short raises IOError; nothing parses
    the short payload."""
    path = str(tmp_path / "shard")
    trecords.append_records(path, _device_infos(tbuilding, 3))
    data = open(path, "rb").read()
    last = len(_device_infos(tbuilding, 3)[2].SerializeToString())
    keep = len(data) - (last + 4) + cut
    with open(path, "wb") as f:
        f.write(data[:keep])
    with pytest.raises(IOError):
        tnative.read_record_payloads(path)
    with pytest.raises(IOError):
        list(trecords.read_records(path, tbuilding.DeviceInfo))
    with pytest.raises(IOError):
        tnative.read_record_payloads(str(tmp_path / "missing"))


def test_library_lies_under_the_build_directory():
    tnative.load("floorplan_ops")
    tnative.load("record_io")
    build_dir = os.path.join(REPO, "sbsim_tpu_torch", "_build")
    for name in ("floorplan_ops", "record_io"):
        path = tnative.library_path(name)
        assert os.path.dirname(path) == build_dir
        assert os.path.basename(path).startswith(f"lib{name}_") and os.path.exists(path)
        assert not os.path.exists(os.path.join(REPO, "sbsim_tpu_torch", "native", f"lib{name}.so"))


def test_failed_build_raises_without_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_LIBS", {})
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler-for-the-port")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnative.connected_components_4(np.ones((3, 3)))
    with pytest.raises(RuntimeError):
        tnative.read_record_payloads(str(tmp_path / "shard"))
    monkeypatch.setattr(tnative, "CXX", "g++")
    monkeypatch.setattr(tnative, "CXX_FLAGS", ("-O3", "-shared", "-fPIC", "-fno-such-flag-for-the-port"))
    with pytest.raises(RuntimeError, match="failed on"):
        tnative.distance_transform_edt(np.ones((3, 3)))
    assert os.listdir(tmp_path) == []


_BUILD_AND_USE = """
import sys
import numpy as np
from sbsim_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
img = np.random.default_rng(int(sys.argv[2])).random((30, 30)) < 0.5
labels = native.connected_components_4(img)
np.save(sys.argv[3], labels)
print(native.library_path("floorplan_ops"))
"""


def test_concurrent_builds_all_load_a_working_library(tmp_path):
    build_dir = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_USE, build_dir, str(i),
                               str(tmp_path / f"labels{i}.npy")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for i in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({out.strip() for out, _ in outs}) == 1
    assert [n for n in os.listdir(build_dir) if n.endswith(".so")] == [
        os.path.basename(outs[0][0].strip())]
    assert not [n for n in os.listdir(build_dir) if n.endswith(".tmp")]
    for i in range(4):
        img = np.random.default_rng(i).random((30, 30)) < 0.5
        np.testing.assert_array_equal(np.load(tmp_path / f"labels{i}.npy"),
                                      ndimage.label(img, structure=CROSS)[0])
