"""Structural rows of the port's hand-written CUDA kernels, the twin of
``benchmarks/kernel_bench.py`` (which derives VMEM and MXU figures of the
Pallas kernels from their tiling).

For each kernel, built from the sources in this checkout, at the
instantiation and launch its main path uses: registers a thread and
static shared memory (``cuobjdump --dump-resource-usage`` of the built
library), threads a block and dynamic shared memory (the launch plan the
wrapper computes, or the one the built source reports), blocks resident on an
SM (the smaller of the register file's, shared memory's, and the SM's
thread and block limits), arithmetic intensity at the main-path shape
(``kernel.work``: operations over bytes), and whether the tile fits the
tensor-core instruction it runs on:

    python -m repro_torch.benchmarks.kernel_bench

Needs nvcc and cuobjdump (the CUDA toolkit); no card is touched.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import torch

SMEM_PER_SM = 228 * 1024  # bytes of shared memory an SM (H100)
SMEM_RESERVED = 1024  # bytes the driver keeps a block
REGS_PER_SM = 65536
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
SMS = 132  # H100 SXM


def resource_usage(lib: Path) -> dict[str, dict]:
    """``{mangled kernel: {"REG", "STACK", "SHARED", "LOCAL"}}`` of a built
    library, from ``cuobjdump --dump-resource-usage``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-resource-usage", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function (\S+):", ln)
        if m:
            fn = m.group(1)
            continue
        if fn and "REG:" in ln:
            out[fn] = {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", ln)}
            fn = None
    return out


def demangle(name: str) -> str:
    """``kernel<args>`` of a mangled name: no namespace, no parameter list,
    no casts of template values (cu++filt writes ``(int)64``)."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return name
    out = subprocess.run([tool], input=name, capture_output=True, text=True, timeout=60)
    full = re.sub(r"\((?:unsigned )?(?:int|bool)\)", "", out.stdout.strip())
    for prefix in ("void ", "(anonymous namespace)::", "<unnamed>::"):
        full = full.replace(prefix, "")
    return full.split("(")[0] or name


def resident_blocks(regs: int, threads: int, smem: int) -> dict:
    """Blocks an SM holds at once, and what limits it: registers are
    allocated 256 a warp at a time, shared memory with the driver's 1 KB a
    block."""
    warps = -(-threads // 32)
    by_regs = REGS_PER_SM // (warps * -(-regs * 32 // 256) * 256) if regs else BLOCKS_PER_SM
    by_smem = SMEM_PER_SM // (smem + SMEM_RESERVED)
    limits = {"registers": by_regs, "shared memory": by_smem,
              "threads": THREADS_PER_SM // threads, "blocks": BLOCKS_PER_SM}
    by = min(limits, key=limits.get)
    return {"blocks": limits[by], "limited_by": by}


def main_path_launches() -> list[dict]:
    """Each kernel's main-path launch: which instantiation (a pattern of its
    demangled name), its threads and dynamic shared memory, its work at the
    main-path shape, and the tensor-core tile check."""
    from ..kernels.flash_attention import kernel as fa
    from ..kernels.gemm_int8 import kernel as gemm
    from ..kernels.rwkv6 import kernel as wkv6
    from ..kernels.ssd_scan import kernel as ssd

    rows = []
    # flash attention, qwen3-0.6b prefill: fp32, hd 128, 16 heads on 8 groups,
    # 4 x 1024 causal (the launch the built source reports)
    hd = 128
    p = fa.plan(hd, torch.float32)
    flops, n_bytes = fa.work((4, 1024, 16, hd), (4, 1024, 8, hd), True, None, 4)
    aligned = p["bq"] % 16 == 0 and p["bk"] % 8 == 0 and hd % 8 == 0
    rows.append({"name": "flash_attention", "source": fa.SOURCE,
                 "match": r"flash_fwd_kernel<float, 128>", "threads": p["threads"],
                 "dynamic_smem": p["smem_bytes"], "flops": flops, "bytes": n_bytes,
                 "tensor_cores": f"mma.sync m16n8k8 tf32 (3xTF32): q tile {p['bq']} x {hd}, "
                                 f"kv tile {p['bk']} x {hd}, aligned {aligned}"})
    # wkv6, rwkv6-7b prefill: b 4, s 1024, H 64, P 64 (the plan the wrapper picks)
    p = wkv6.plan(4, 1024, 64, 64)
    flops, n_bytes = wkv6.work(4, 1024, 64, 64)
    rows.append({"name": "wkv6", "source": wkv6.SOURCE,
                 "match": rf"wkv6_kernel<64, {p['r']}, {p['pc']}, {p['cpt']}>",
                 "threads": p["threads"], "dynamic_smem": p["smem_bytes"], "flops": flops,
                 "bytes": n_bytes, "tensor_cores": "none: fp32 FMA recurrence on CUDA cores"})
    # SSD scan, zamba2-7b prefill: b 4, s 1024, H 112, P 64, N 64
    p = ssd.plan(64, 64, 1024)
    flops, n_bytes = ssd.work(4, 1024, 112, 64, 64)
    rows.append({"name": "ssd_scan", "source": ssd.SOURCE,
                 "match": rf"ssd_scan_kernel<64, {p['r']}, {p['pc']}, {p['cpt']}>",
                 "threads": p["threads"], "dynamic_smem": p["smem_bytes"], "flops": flops,
                 "bytes": n_bytes, "tensor_cores": "none: fp32 FMA recurrence on CUDA cores"})
    # INT8 GEMM, ResNet-50 layer3 3x3 conv at batch 16: M 4096, N 256, K 2304,
    # w column-major, the residual staged in shared memory
    M, N, K = 4096, 256, 2304
    bn = gemm.block_n(M, N, SMS)
    p = gemm.kmajor_plan(bn)
    aligned = gemm.BM % 16 == 0 and bn % 8 == 0 and gemm.BK % 32 == 0
    rows.append({"name": "gemm_int8", "source": gemm.SOURCE,
                 "match": rf"gemm_kernel<{bn}, {p['wm']}", "threads": p["threads"],
                 "dynamic_smem": p["smem_bytes"], "flops": 2 * M * N * K,
                 "bytes": M * K + K * N + 4 * N + M * N,
                 "tensor_cores": f"mma.sync m16n8k32 s8: block {gemm.BM} x {bn} x {gemm.BK}, "
                                 f"aligned {aligned}"})
    return rows


def run() -> list[str]:
    from ..kernels import SOURCES, _build

    built = _build.build(SOURCES)
    rows = []
    for r in main_path_launches():
        usage = resource_usage(built[r["name"]].path)
        names = {demangle(fn): u for fn, u in usage.items()}
        hits = [(n, u) for n, u in names.items() if re.search(r["match"], n)]
        if not hits:
            raise RuntimeError(f"{r['name']}: no kernel matching {r['match']!r} in "
                               f"{sorted(names)}")
        fn, u = hits[0]
        smem = u["SHARED"] + r["dynamic_smem"]
        occ = resident_blocks(u["REG"], r["threads"], smem)
        rows.append(
            f"kernel.{r['name']},,function={fn};regs={u['REG']};stack={u['STACK']};"
            f"local={u['LOCAL']};threads={r['threads']};static_smem={u['SHARED']};"
            f"dynamic_smem={r['dynamic_smem']};smem_kib={smem / 1024:.1f};"
            f"fits={int(smem + SMEM_RESERVED <= SMEM_PER_SM)};"
            f"blocks_per_sm={occ['blocks']};limited_by={occ['limited_by']};"
            f"arith_intensity={r['flops'] / r['bytes']:.1f};tensor_cores={r['tensor_cores']}")
    return rows


if __name__ == "__main__":
    print("\n".join(run()))
