"""How far each fp32 order of bf16(q)·x lies from the exact sum, on a near-duplicate.

    python3 tests/bf16_sum_witness.py card OUT.npz                  # on the GPU
    JAX_PLATFORMS=cpu python3 tests/bf16_sum_witness.py cpu OUT.npz  # then on the CPU

The case is ``test_bf16_list_scan_vs_plain[dup_ties-384-False]`` of
tests/test_torch_kernels_cuda.py: ``list_case`` seed 17, 20,000 x 384
rows in 128 lists, 130 queries at nprobe 3, k 10, L2, query 0 a row copied
into two lists. Its near-duplicate's score, -max(‖q‖² - 2·bf16(q)·x + ‖x‖²,
0), cancels two norms of ~128 down to ~0.01, so the order in which fp32
sums the 384 exact products shows in it.

``card`` (torch and the port only) runs, on the card, the bf16 list scan
without promote (the tensor-core kernel), the CUDA-core kernel's wide bf16
mode at k 129 (its first 10), and the port's plain version (cuBLAS's fp32
product, TF32 off), and writes their top 10 to OUT.npz. ``cpu`` (with the
JAX package) adds the port's plain version on the CPU and the JAX package's
K2 bf16 kernel (``pallas_ivf_topk``, Pallas in interpret mode) and the
``cuda`` tests' reference (``_torch_parity.ivf_plain_exact``), then prints,
for each, the largest |score - exact| over the hits and on query 0's first
hit, where the exact score sums every product and norm in float64 from the
same inputs (the stored fp32 ‖x‖²).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]   # _torch_parity, and the packages

N, B, D, KC, NPROBE, K = 20_000, 130, 384, 128, 3, 10


def _case():
    from _torch_parity import list_case

    return list_case(17, N, B, D, KC, NPROBE, dup=True)


def card(out: str) -> None:
    import torch
    from _torch_parity import as_tensor, csr

    from pyrope_tpu_torch.ops import fused_scan as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    case = _case()
    x, q, sq, alive, crow, probe = (as_tensor(a).to(dev) for a in case)
    offs, lens = (t.to(dev) for t in csr(case[4], KC))
    x16, ml = x.bfloat16(), int(lens.max())
    got = {}
    before = dict(fs.LAUNCHES)
    got["tc_kernel"] = fs.fused_ivf_topk(q, x16, sq, alive, crow, offs, lens, probe, KC, K,
                                         max_len=ml)
    wv, wi = fs.fused_ivf_topk(q, x16, sq, alive, crow, offs, lens, probe, KC, 129,
                               max_len=ml)
    got["cuda_core_kernel_wide"] = (wv[:, :K], wi[:, :K])
    assert fs.LAUNCHES["ivf_scan_bf16_tc"] == before["ivf_scan_bf16_tc"] + 1
    assert fs.LAUNCHES["ivf_scan_bf16_wide"] == before["ivf_scan_bf16_wide"] + 1
    got["plain_cublas_fp32"] = fs.fused_ivf_topk_plain(q, x16, sq, alive, crow, probe, KC, K)
    torch.cuda.synchronize()
    np.savez(out, **{f"{name}_{part}": t.cpu().numpy()
                     for name, (v, i) in got.items() for part, t in (("v", v), ("i", i))})
    print(f"wrote {out}: {sorted(got)}")


def cpu(path: str) -> None:
    import jax.numpy as jnp
    import torch
    from _torch_parity import as_tensor, csr, ivf_plain_exact

    from pyrope_tpu.ops.pallas_scan import pallas_ivf_topk
    from pyrope_tpu.types import Metric
    from pyrope_tpu_torch.ops import fused_scan as fs

    x, q, sq, alive, crow, probe = _case()
    saved = np.load(path)
    got = {name: (saved[f"{name}_v"], saved[f"{name}_i"])
           for name in ("tc_kernel", "cuda_core_kernel_wide", "plain_cublas_fp32")}
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offs, lens = csr(crow, KC)
    pv, pi = fs.fused_ivf_topk(t[0], t[1].bfloat16(), t[2], t[3], t[4], offs, lens, t[5], KC,
                               K, max_len=int(lens.max()))
    got["plain_cpu_fp32"] = (pv.numpy(), pi.numpy())
    ev, ei = ivf_plain_exact(t[0], t[1].bfloat16(), t[2], t[3], t[4], t[5], KC, K)
    got["tests_ivf_plain_exact"] = (ev.numpy(), ei.numpy())
    probed = np.zeros((B, KC), np.float32)
    probed[np.arange(B)[:, None], probe] = 1.0
    jv, ji = pallas_ivf_topk(jnp.asarray(q), jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(sq), jnp.asarray(alive), jnp.asarray(crow),
                             jnp.asarray(probed), K, Metric.L2, row_tile=800, batch_tile=B)
    got["jax_k2_bf16_interpret"] = (np.asarray(jv), np.asarray(ji))
    # the exact score of (query, row): float64 throughout from the same inputs
    q16 = t[0].bfloat16().double().numpy()
    x16 = t[1].bfloat16().double().numpy()
    qq = (q.astype(np.float64) ** 2).sum(1)

    def exact(b, r):
        return -max(qq[b] - 2.0 * float(q16[b] @ x16[r]) + float(sq[r]), 0.0)

    ref = got["tc_kernel"][1]
    print(f"{'version':<24} {'same hits':>9} {'max |err| (all hits)':>21} "
          f"{'query 0 hit 1':>16} {'its err':>10}")
    for name, (v, i) in got.items():
        errs = [abs(float(v[b, j]) - exact(b, int(i[b, j])))
                for b in range(B) for j in range(K) if i[b, j] >= 0]
        same = all(set(i[b].tolist()) == set(ref[b].tolist()) for b in range(B))
        e0 = exact(0, int(i[0, 0]))
        print(f"{name:<24} {str(same):>9} {max(errs):>21.3e} {float(v[0, 0]):>16.8f} "
              f"{abs(float(v[0, 0]) - e0):>10.3e}")
    print(f"{'exact (float64)':<24} {'':>9} {'':>21} {exact(0, int(ref[0, 0])):>16.8f}")


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("card", "cpu"):
        raise SystemExit(__doc__.split("\n\n")[0] + "\nusage: bf16_sum_witness.py card|cpu OUT.npz")
    (card if sys.argv[1] == "card" else cpu)(sys.argv[2])
