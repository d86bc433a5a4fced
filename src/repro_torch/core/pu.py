"""Processing Unit model: heterogeneous systolic-array PUs of the baseline
architecture [16] that this paper builds on.

The Alveo U50 system instantiates 5x PU_1x (64x4 SA) + 5x PU_2x (64x8 SA)
across the two SLRs; DSPs run at dsp_clk = 600 MHz (2x sys_clk = 300 MHz).

    peak MACs/cycle = sa_rows * sa_cols          (64*4=256 / 64*8=512)
    peak TOPS       = rows*cols * 2 * dsp_clk    (0.3072 / 0.6144)
    system peak     = 5*0.3072 + 5*0.6144 = 4.608 TOPS   (Table III "DP-*")

Timing model (cycle-approximate, validated against the paper's 98 % CE on
ResNet-50): a GEMM of (M out-channels x N positions x K reduction) executes in

    dsp_cycles = ceil(M/rows) * ( ceil(N/cols) * K  + WAVE_FILL )

i.e. output channels tile over the 64-row dimension ("computational tiles
matching the first SA dimension", Sec. IV-A), spatial positions stream over
the columns, and each wave pays a fixed pipeline-fill overhead. Efficiency
losses are exactly the M/N tiling quantization + fill — which reproduces
~98 % on ResNet-50 conv layers and the FC-layer inefficiency.

Memory: each PU owns 64 URAMs x 36 KiB = 2.25 MiB of weight storage (640
URAMs system-wide = 100 % utilization, Table II) and talks to HBM through
dedicated AXI DataMover channels at ~14.4 GB/s/channel (256-bit @ 450 MHz,
consistent with Shuhai [33] measurements).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

SYS_CLK_HZ = 300e6
DSP_CLK_HZ = 600e6
HBM_CHANNEL_BW = 14.4e9  # bytes/s per AXI channel
URAM_BYTES = 36 * 1024  # one URAM: 4K x 72b = 36 KiB
WAVE_FILL_CYCLES = 96  # SA pipeline fill+drain per output-channel wave (dsp_clk)
N_HBM_CHANNELS = 32  # HBM2 pseudo-channels on the U50
STREAM_TILE_BYTES = 4096  # granularity of the BRAM ping-pong tile streaming


@dataclass(frozen=True)
class PUSpec:
    pid: int
    kind: str  # "PU1x" | "PU2x"
    sa_rows: int
    sa_cols: int
    slr: int
    n_urams: int = 64
    act_buf_slots: int = 2  # ping-pong input activation BRAM buffers
    out_buf_slots: int = 2  # output buffers drained by the ST group
    dsp_clk_hz: float = DSP_CLK_HZ
    sys_clk_hz: float = SYS_CLK_HZ
    hbm_channel_bw: float = HBM_CHANNEL_BW

    # -- capability ----------------------------------------------------------
    @property
    def macs_per_dsp_cycle(self) -> int:
        return self.sa_rows * self.sa_cols

    @property
    def peak_tops(self) -> float:
        return self.macs_per_dsp_cycle * 2 * self.dsp_clk_hz / 1e12

    @property
    def n_dsps(self) -> int:
        # one DSP48E2 per SA MAC plus a small vector-unit allowance is folded
        # into the SA count for the CE metric, consistent with [16].
        return self.sa_rows * self.sa_cols

    @property
    def uram_capacity_bytes(self) -> int:
        return self.n_urams * URAM_BYTES

    # -- timing --------------------------------------------------------------
    def gemm_dsp_cycles(self, m: int, n: int, k: int) -> float:
        """Cycle count (dsp_clk) for an M x N x K GEMM on the SA."""
        waves = math.ceil(m / self.sa_rows)
        per_wave = math.ceil(n / self.sa_cols) * k + WAVE_FILL_CYCLES
        return waves * per_wave

    def gemm_sys_cycles(self, m: int, n: int, k: int) -> float:
        return self.gemm_dsp_cycles(m, n, k) * self.sys_clk_hz / self.dsp_clk_hz

    def gemm_seconds(self, m: int, n: int, k: int) -> float:
        return self.gemm_dsp_cycles(m, n, k) / self.dsp_clk_hz

    def gemm_efficiency(self, m: int, n: int, k: int) -> float:
        useful = m * n * k
        return useful / (self.gemm_dsp_cycles(m, n, k) * self.macs_per_dsp_cycle)

    def adm_sys_cycles(self, nbytes: int) -> float:
        """sys_clk cycles for one ADM transfer of ``nbytes`` over one HBM
        channel (latency-dominated floor of ~40 cycles for tiny bursts)."""
        return max(40.0, nbytes / self.hbm_channel_bw * self.sys_clk_hz)

    def adm_seconds(self, nbytes: int) -> float:
        return self.adm_sys_cycles(nbytes) / self.sys_clk_hz

    def stream_tile_cycles(self, nbytes: int) -> float:
        """Time until the *first tile* of a streamed transfer is usable by
        the SA (the BRAM ping-pong buffers stream tiles, so compute starts
        after one tile, not after the full transfer)."""
        tile = min(nbytes, STREAM_TILE_BYTES)
        return max(40.0, tile / self.hbm_channel_bw * self.sys_clk_hz)


def make_u50_system() -> list[PUSpec]:
    """The paper's 10-PU Alveo U50 configuration: 5x PU1x + 5x PU2x.

    PIDs 0-4 are PU1x on SLR0, PIDs 5-9 are PU2x on SLR1 (Fig. 2(a) places
    the PU types across the two SLRs; the exact floorplan only affects the
    Fig. 2(c) token-latency matrix, not throughput)."""
    pus = [PUSpec(pid=i, kind="PU1x", sa_rows=64, sa_cols=4, slr=0) for i in range(5)]
    pus += [PUSpec(pid=5 + i, kind="PU2x", sa_rows=64, sa_cols=8, slr=1) for i in range(5)]
    return pus


def system_peak_tops(pus: list[PUSpec]) -> float:
    return sum(p.peak_tops for p in pus)
