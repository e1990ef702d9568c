"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's on the CPU: with the reference's hardware constants passed in,
every field of ``as_dict()`` is equal for every (arch × shape × mesh)
cell; at the H100 default only the times, the bottleneck and the
fraction differ.  Pure Python arithmetic in both, so the comparison is
exact.  ``repro.launch.roofline`` sets no XLA flag and starts no JAX
backend."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import roofline as t_roofline  # noqa: E402

REF_HW = t_roofline.Hardware(j_roofline.PEAK_FLOPS, j_roofline.HBM_BW,
                             j_roofline.LINK_BW, 16e9)
CELLS = [(a, s.name, mp) for a in t_configs.ARCH_IDS
         for s in t_configs.SHAPES for mp in (False, True)]
HW_FIELDS = {"t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
             "roofline_fraction"}


def _pair(arch, shape, multi_pod, **kw):
    want = j_roofline.roofline_cell(
        j_configs.get_config(arch), j_configs.shape_by_name(shape),
        multi_pod=multi_pod).as_dict()
    got = t_roofline.roofline_cell(
        t_configs.get_config(arch), t_configs.shape_by_name(shape),
        multi_pod=multi_pod, **kw).as_dict()
    return want, got


def test_reference_constants_are_the_ones_passed():
    assert (REF_HW.peak_flops, REF_HW.hbm_bw, REF_HW.link_bw) == (
        197e12, 819e9, 50e9)


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_roofline_equals_the_reference_with_its_constants(arch, shape,
                                                          multi_pod):
    want, got = _pair(arch, shape, multi_pod, hw=REF_HW)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_h100_default_changes_only_the_hardware_fields():
    h100 = t_roofline.H100
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw, h100.hbm_bytes) == (
        989e12, 3.35e12, 50e9, 80e9)
    for arch, shape, mp in CELLS:
        want, got = _pair(arch, shape, mp)
        for k in want:
            if k not in HW_FIELDS:
                assert got[k] == want[k], (arch, shape, mp, k)
        assert 0 < got["roofline_fraction"] <= 1, (arch, shape, mp)
        t = {"compute": got["t_compute_s"], "memory": got["t_memory_s"],
             "collective": got["t_collective_s"]}
        assert got["bottleneck"] == max(t, key=t.get)
