"""The mesh context (`repro_torch.parallel`, `repro_torch.launch.mesh`)
against the reference's (`repro.parallel.compat`, `repro.launch.mesh`) on
the CPU: axis names and sizes of the same constructions, the innermost
`set_mesh` winning and None outside, the errors the reference raises
(too few devices, a production mesh on one host), and what the port adds
over device slots: slots may repeat, slots of mixed device types raise
`ValueError` (the check `MeshContext` uses), and the mesh is the calling
thread's.
"""

import threading

import pytest
import torch

from repro.launch import mesh as jmesh
from repro.parallel import compat as jcompat
from repro_torch.cluster import MeshContext
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.parallel import (current_axis_sizes, get_abstract_mesh,
                                  make_mesh, set_mesh)

CPU = torch.device("cpu")


@pytest.mark.parametrize("shape,names", [((1,), ("model",)),
                                         ((1, 1), ("data", "model")),
                                         ((1, 1, 1), ("pod", "data",
                                                      "model"))])
def test_make_mesh_matches_reference_axes(shape, names):
    want = jcompat.make_mesh(shape, names)
    got = make_mesh(shape, names, [CPU])
    assert got.axis_names == tuple(want.axis_names)
    assert got.axis_sizes == tuple(want.axis_sizes)
    assert got.size == want.size and not got.empty
    with jcompat.set_mesh(want):
        ref = jcompat.current_axis_sizes()
    with set_mesh(got):
        assert current_axis_sizes() == ref


def test_debug_mesh_slots_repeat_one_device():
    m = make_debug_mesh(2, 4, device="cpu")
    assert m.shape == {"data": 2, "model": 4}
    assert m.devices.shape == (2, 4)
    assert all(d == CPU for d in m.devices.flat)
    pod = make_debug_mesh(2, 2, pod=2, device="cpu")
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.axis_sizes == (2, 2, 2)


def test_set_mesh_nests_and_restores():
    a, b = make_debug_mesh(2, 2, device="cpu"), make_debug_mesh(1, 4,
                                                               device="cpu")
    assert get_abstract_mesh() is None and current_axis_sizes() == {}
    with set_mesh(a):
        assert get_abstract_mesh() is a
        with set_mesh(b):
            assert get_abstract_mesh() is b
            with set_mesh(None):
                assert get_abstract_mesh() is None
            assert current_axis_sizes() == {"data": 1, "model": 4}
        assert get_abstract_mesh() is a
    assert get_abstract_mesh() is None
    with pytest.raises(KeyError), set_mesh(a):
        raise KeyError("exits the context")
    assert get_abstract_mesh() is None


def test_mesh_is_the_calling_threads():
    seen = []
    with set_mesh(make_debug_mesh(2, 2, device="cpu")):
        t = threading.Thread(target=lambda: seen.append(get_abstract_mesh()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [None]


def test_errors_match_reference():
    with pytest.raises(ValueError, match="must be >= the product"):
        jcompat.make_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="must be >= the product"):
        make_mesh((2, 4), ("data", "model"), [CPU] * 7)
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        jmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)


def test_mixed_device_types_raise_as_mesh_context_does():
    for build in (lambda d: make_mesh((2,), ("model",), d),
                  lambda d: MeshContext(devices=d)):
        with pytest.raises(ValueError, match="several device types"):
            build([CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="at least one"):
        MeshContext(devices=[])
    with pytest.raises(ValueError, match="repeated mesh axis"):
        make_mesh((1, 1), ("model", "model"), [CPU])


def test_debug_mesh_without_device_needs_a_card():
    if torch.cuda.is_available():
        assert make_debug_mesh(1, 2).devices.flat[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_debug_mesh(1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1,), ("model",))
