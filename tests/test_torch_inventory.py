"""The port covers the JAX side: every file, public name and entry-point
flag of it maps to the port, or to a decision recorded in ROADMAP.md.

The JAX side is each ``.py`` and data file under ``pyrope_tpu/``, each
file under ``scripts/`` and ``examples/``, ``bench.py``,
``__graft_entry__.py`` and ``native/hnsw_builder.cc``. Four families of
cases, one case an item:
- files: each maps to existing files of the port (by default the same path
  under ``pyrope_tpu_torch/``, ``pyrope_tpu_torch/scripts/`` for
  ``scripts/``), or to a decision string;
- names: each public module-level function and class of a JAX module is
  in its twin, in a named module it moved to (maybe renamed), or has a
  decision string; likewise what each JAX package ``__init__`` exports
  (``__all__`` and its lazy table) the twin package gives;
- flags: each ``add_argument`` flag of a JAX entry point is in its twin,
  or maps to a named counterpart there;
- the shell twins never name the JAX package (``pyrope_tpu`` without the
  ``_torch`` suffix).
Everything is read from the sources (``ast``): no JAX module is imported.
"""

import ast
import functools
import importlib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = "pyrope_tpu_torch"

# JAX-side files whose twin is not the same path under the port
TWIN_FILES = {
    "pyrope_tpu/ops/pallas_scan.py": ("pyrope_tpu_torch/ops/fused_scan.py",
                                      "pyrope_tpu_torch/csrc/fused_scan.cu",
                                      "pyrope_tpu_torch/csrc/ivf_list_scan.cu"),
    "examples/quickstart.py": ("pyrope_tpu_torch/scripts/quickstart.py",),
    "examples/pyrope_tpu_demo.ipynb": ("pyrope_tpu_torch/examples/pyrope_tpu_torch_demo.ipynb",),
    "bench.py": ("pyrope_tpu_torch/scripts/bench.py",),
    # its dry run (the sharded paths on a CPU mesh) and its entry check
    "__graft_entry__.py": ("pyrope_tpu_torch/parallel/dryrun.py", "chip_smoke.py"),
}
# JAX-side files with no twin, and why
DECIDED_FILES = {
    "pyrope_tpu/ops/scalars.py": "ROADMAP Decisions, not ported by design: device-resident "
                                 "int32 scalars for the TPU link; the port passes ints",
    "pyrope_tpu/ops/transfer.py": "ROADMAP Decisions, not ported by design: chunked uploads "
                                  "for the TPU link (upload_rows); the port uses .to(device)",
    "scripts/generate_mtls_certs.sh": "shared: no Python package (openssl only); both "
                                      "packages' sidecars and clients read its certificates",
    "scripts/torch_hnsw_bf16_gap.py": "the port's own tool: computes chip_smoke's "
                                      "HNSW100K_GRAPH_SHA256 and HNSW_BF16_GAP_JAX with "
                                      "both packages on the CPU",
    "native/hnsw_builder.cc": "shared: no Python package; pyrope_tpu_torch/native/build.py "
                              "compiles this source into a library of its own",
}
# public names that moved to another module of the port: (file, name)
MOVED = {
    ("pyrope_tpu/ops/pallas_scan.py", "pallas_flat_topk"):
        ("pyrope_tpu_torch/ops/fused_scan.py", "fused_flat_topk"),
    ("pyrope_tpu/ops/pallas_scan.py", "pallas_ivf_topk"):
        ("pyrope_tpu_torch/ops/fused_scan.py", "fused_ivf_topk"),
    ("pyrope_tpu/ops/pallas_scan.py", "pallas_ivf_sq8_topk"):
        ("pyrope_tpu_torch/ops/fused_scan.py", "fused_ivf_sq8_topk"),
    # K3 and K5 are folded into the list scan (ROADMAP Decisions)
    ("pyrope_tpu/ops/pallas_scan.py", "pallas_ivf_topk_windowed"):
        ("pyrope_tpu_torch/ops/fused_scan.py", "fused_ivf_topk"),
    ("pyrope_tpu/ops/pallas_scan.py", "pallas_ivf_sq8_topk_windowed"):
        ("pyrope_tpu_torch/ops/fused_scan.py", "fused_ivf_sq8_topk"),
    # the VMEM budget is not ported; the hybrid shortlist keeps a copy
    ("pyrope_tpu/ops/pallas_scan.py", "pick_row_tile"):
        ("pyrope_tpu_torch/index/flat.py", "pick_row_tile"),
    ("pyrope_tpu/index/ivf_pq.py", "sq8res_encode_host"):
        ("pyrope_tpu_torch/ops/slab.py", "sq8res_encode_host"),
    # a jittable IVF-Flat search step and its inputs: the smoke drives the
    # port's search paths on the card
    ("__graft_entry__.py", "entry"): ("chip_smoke.py", "main"),
    # the XLA compilation cache: the kernels are built or loaded instead
    ("pyrope_tpu/server/app.py", "enable_compilation_cache"):
        ("pyrope_tpu_torch/kernels/build.py", "load"),
}
_FOLDED = ("ROADMAP Decisions: K3 and K5 folded into one list scan; the probe inversion "
           "(ops/fused_scan.invert_probes) builds its work tables")
_SHARD_MAP = ("ROADMAP Decisions: the sharded families run under one controller "
              "(parallel/mesh.sharded_call), not as shard_map bodies")
DECIDED_NAMES = {
    ("pyrope_tpu/ops/pallas_scan.py", "padded_probe_width"): _FOLDED,
    ("pyrope_tpu/ops/pallas_scan.py", "tile_cluster_windows"): _FOLDED,
    ("pyrope_tpu/index/ivf_flat.py", "probed_table"): _FOLDED,
    ("pyrope_tpu/index/ivf_flat.py", "probed_table_t"): _FOLDED,
    ("pyrope_tpu/parallel/sharded_ivf.py", "shard_tile_windows"):
        "ROADMAP Decisions: each shard's list scan reads its local CSR; no tile windows",
    ("pyrope_tpu/parallel/mesh.py", "flat_row_shard_index"): _SHARD_MAP,
    ("pyrope_tpu/parallel/mesh.py", "hierarchical_merge_topk"):
        "ROADMAP Decisions: a multi-slice mesh merges every row shard in one step",
    ("pyrope_tpu/parallel/sharded_hnsw.py", "make_sharded_hnsw_search"): _SHARD_MAP,
    ("pyrope_tpu/parallel/sharded_hnsw.py", "make_sharded_hnsw_corpus_search"): _SHARD_MAP,
    ("scripts/measure_sharded_ivf_skew.py", "fmt"):
        "a formatter of the JAX script's text report; the twin prints JSON",
}
# names a JAX package __init__ exports that its twin does not
DECIDED_EXPORTS = {
    ("pyrope_tpu/ops/__init__.py", "pallas_flat_topk"):
        "renamed: pyrope_tpu_torch.ops.fused_flat_topk, the flat scan kernel's wrapper",
    ("pyrope_tpu/ops/__init__.py", "device_i32"): DECIDED_FILES["pyrope_tpu/ops/scalars.py"],
}
# JAX flags whose twin flag has another name (ROADMAP Decisions: --device)
FLAG_MAP = {
    ("pyrope_tpu/server/app.py", "--platform"): "--device",
    ("scripts/soak_test.py", "--platform"): "--device",
    ("scripts/quality_gate.py", "--cpu"): "--device",    # --device cpu
    ("scripts/profile_hnsw.py", "--xprof"): "--trace",
}


def _jax_side_files() -> list[str]:
    files = [p for top in ("pyrope_tpu", "scripts", "examples") for p in (REPO / top).rglob("*")
             if p.is_file() and "__pycache__" not in p.parts and p.suffix not in (".pyc", ".so")]
    files += [REPO / name for name in ("bench.py", "__graft_entry__.py", "native/hnsw_builder.cc")]
    return sorted(str(p.relative_to(REPO)) for p in files)


JAX_FILES = _jax_side_files()


def twins(path: str) -> tuple[str, ...]:
    if path in TWIN_FILES:
        return TWIN_FILES[path]
    if path.startswith("pyrope_tpu/"):
        return (PORT + path[len("pyrope_tpu"):],)
    if path.startswith("scripts/"):
        return (f"{PORT}/{path}",)
    raise KeyError(f"{path}: no twin named")


def _pairs() -> list[tuple[str, str]]:
    """(JAX module, its twin module) for every Python file of the JAX side
    that has one Python twin or more (the first is the module's)."""
    out = []
    for path in JAX_FILES:
        if path.endswith(".py") and path not in DECIDED_FILES:
            twin = twins(path)[0]
            if twin.endswith(".py"):
                out.append((path, twin))
    return out


PAIRS = _pairs()


@functools.lru_cache(maxsize=None)
def _tree(path: str) -> ast.Module:
    return ast.parse((REPO / path).read_text(), filename=path)


def _top_level(path: str):
    """The module's statements, those under a top-level if/try included."""
    for node in _tree(path).body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from node.body
            yield from node.orelse
            for handler in getattr(node, "handlers", ()):
                yield from handler.body
        else:
            yield node


def public_defs(path: str) -> list[str]:
    """Public module-level functions and classes."""
    return sorted({n.name for n in _top_level(path)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                   and not n.name.startswith("_")})


@functools.lru_cache(maxsize=None)
def module_names(path: str) -> frozenset:
    """Every name bound at module level: definitions, assignments, imports."""
    names = set()
    for n in _top_level(path):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for target in n.targets if isinstance(n, ast.Assign) else [n.target]:
                names.update(t.id for t in ast.walk(target) if isinstance(t, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
    return frozenset(names)


def exports(path: str) -> list[str]:
    """What a package ``__init__`` exports: its ``__all__`` and the keys of
    the lazy table in its module ``__getattr__``."""
    out = set()
    for n in _top_level(path):
        if (isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__" for t in n.targets)):
            out.update(ast.literal_eval(n.value))
        if isinstance(n, ast.FunctionDef) and n.name == "__getattr__":
            for d in ast.walk(n):
                if isinstance(d, ast.Dict) and d.keys:
                    out.update(k.value for k in d.keys if isinstance(k, ast.Constant))
    return sorted(out)


def flags(path: str) -> list[str]:
    """The option strings of every ``add_argument`` call in the file."""
    return sorted({a.value for n in ast.walk(_tree(path))
                   if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "add_argument"
                   for a in n.args if isinstance(a, ast.Constant) and isinstance(a.value, str)
                   and a.value.startswith("-")})


def _cases(fn) -> list:
    return [pytest.param(jax, twin, item, id=f"{jax}::{item}")
            for jax, twin in PAIRS for item in fn(jax)]


def _decision_ok(reason: str) -> bool:
    """A decision names the ROADMAP decision or gives a reason: a sentence."""
    return len(reason.split()) >= 4


# ---- files -----------------------------------------------------------------


@pytest.mark.parametrize("path", JAX_FILES)
def test_every_jax_side_file_maps_to_the_port(path):
    if path in DECIDED_FILES:
        assert _decision_ok(DECIDED_FILES[path]), DECIDED_FILES[path]
        return
    missing = [t for t in twins(path) if not (REPO / t).is_file()]
    assert not missing, f"{path}: its twin {missing} does not exist"


def test_the_maps_name_only_jax_side_files():
    """No stale entry: every key of the maps is a JAX-side file (or a
    name or flag of one)."""
    keys = {*TWIN_FILES, *DECIDED_FILES}
    keys |= {f for f, _ in (*MOVED, *DECIDED_NAMES, *DECIDED_EXPORTS, *FLAG_MAP)}
    assert keys <= set(JAX_FILES), sorted(keys - set(JAX_FILES))
    assert not set(TWIN_FILES) & set(DECIDED_FILES)


def test_the_shared_native_source_is_the_ports():
    assert "hnsw_builder.cc" in (REPO / PORT / "native" / "build.py").read_text()


# ---- names -----------------------------------------------------------------


@pytest.mark.parametrize("jax_path, twin_path, name", _cases(public_defs))
def test_every_public_name_maps_to_the_port(jax_path, twin_path, name):
    if (jax_path, name) in DECIDED_NAMES:
        assert _decision_ok(DECIDED_NAMES[(jax_path, name)])
        return
    where, new = MOVED.get((jax_path, name), (twin_path, name))
    assert new in module_names(where), f"{jax_path}: {name} is not in {where} (as {new})"


@pytest.mark.parametrize(
    "jax_path, twin_path, name",
    [case for case in _cases(exports) if case.values[0].endswith("__init__.py")])
def test_every_package_export_maps_to_the_port(jax_path, twin_path, name):
    if (jax_path, name) in DECIDED_EXPORTS:
        assert _decision_ok(DECIDED_EXPORTS[(jax_path, name)])
        return
    package = twin_path[:-len("/__init__.py")].replace("/", ".")
    assert hasattr(importlib.import_module(package), name), f"{package} lacks {name}"


def test_moved_names_live_where_the_map_says():
    for (jax_path, name), (where, new) in MOVED.items():
        assert name in public_defs(jax_path), (jax_path, name)
        assert new in module_names(where), (where, new)
    for jax_path, name in DECIDED_NAMES:
        assert name in public_defs(jax_path), (jax_path, name)


# ---- flags -----------------------------------------------------------------


def twin_flags(path: str) -> list[str]:
    """A twin's flags, with ``--device`` and ``--out`` where it takes the
    tools' common flags (``scripts.add_common``)."""
    common = flags(f"{PORT}/scripts/__init__.py") if "add_common" in module_names(path) else []
    return flags(path) + common


@pytest.mark.parametrize("jax_path, twin_path, flag", _cases(flags))
def test_every_entry_point_flag_maps_to_the_port(jax_path, twin_path, flag):
    want = FLAG_MAP.get((jax_path, flag), flag)
    assert want in twin_flags(twin_path), f"{twin_path} has no {want} (the JAX side's {flag})"


# ---- the shell twins --------------------------------------------------------

SHELL_TWINS = sorted(t for p in JAX_FILES if p.endswith(".sh") and p not in DECIDED_FILES
                     for t in twins(p))


@pytest.mark.parametrize("path", SHELL_TWINS)
def test_shell_twins_never_name_the_jax_package(path):
    text = (REPO / path).read_text()
    assert not re.findall(r"\bpyrope_tpu(?!_torch)", text), path
