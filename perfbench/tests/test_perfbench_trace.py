"""The trace's reduction on made-up events: kernel names, busy and idle
time, the breakdown."""

from core import manifest
from core.trace import Trace, kernel_base, library_kernels


def test_kernel_base_strips_namespaces_templates_and_parameters():
    assert kernel_base("void (anonymous namespace)::ivf_list_scan_kernel<1, false>"
                       "(float const*, void const*)") == "ivf_list_scan_kernel"
    assert kernel_base("(anonymous namespace)::merge_partials_kernel(float const*, int)") \
        == "merge_partials_kernel"
    assert kernel_base("void at::native::vectorized_elementwise_kernel<4, F>(int, F)") \
        == "vectorized_elementwise_kernel"
    assert kernel_base("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def test_library_kernels_names_the_list_scan():
    src = manifest.module("adapters", "ivf").SOURCES
    lib = library_kernels(src)
    mine = manifest.module("metrics", "list_scan_ms").names(lib)
    assert {"ivf_list_scan_kernel", "invert_probes_kernel", "merge_partials_kernel"} <= mine
    assert "fused_scan_kernel" in lib and "fused_scan_kernel" not in mine


def test_busy_idle_and_breakdown():
    ev = [("void a_kernel<1>(int)", 10, 30), ("void b_kernel(int)", 20, 40),
          ("Memcpy DtoH (Device -> Pinned)", 60, 70), ("void a_kernel<2>(int)", 95, 120)]
    spans = [("search", 0, 50), ("wait", 50, 100)]
    t = Trace(ev, 0, 100, 2, spans, [0, 1])
    assert t.busy() == [(10, 40), (60, 70), (95, 100)]
    assert t.busy_s() == 45e-9
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["a_kernel", 45e-9]
    gaps = dict(bd["idle_gaps"])
    assert gaps == {"host:search": 10e-9, "host:wait": 20e-9 + 25e-9}   # by each gap's midpoint
