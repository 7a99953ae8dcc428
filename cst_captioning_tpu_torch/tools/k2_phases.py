"""Phase timeline of the K2 and K1 kernels on the card.

    python -m cst_captioning_tpu_torch.tools.k2_phases

Builds a copy of ``csrc/decode_cell.cu`` and ``csrc/attention.cuh`` in
which thread 0 of each block writes the device clock (``%globaltimer``,
ns) at the boundaries of the kernels' phases, runs K1 alone and K2 (CUDA
graph replay and eager launches) at the serving shapes (B in 1, 8, 40;
T=29, E=H=A=512), and prints, in microseconds from the first block's
start: each attention block's phases, and the median / min / max over
the gate blocks of each gate phase (at B=40 also the second row group's
phases).  The stamps cost a few instructions each; the kernels' own
times are ``chip_smoke.py``'s.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from cst_captioning_tpu_torch.ops import _cuda
from cst_captioning_tpu_torch.ops.attention_kernel import attention_geometry
from cst_captioning_tpu_torch.ops.decode_cell_kernel import gate_geometry

T, E, H, A = 29, 512, 512, 512
ATTN_SLOT = 512             # stamp rows of the attention blocks of row 0
STAMPS = """
__device__ unsigned long long g_stamps[1024][16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { if (threadIdx.x == 0) \\
  g_stamps[blockIdx.x][i] = gtime(); } while (0)
#define ASTAMP(i) do { if (blockIdx.y == 0 && threadIdx.x == 0) \\
  g_stamps[512 + blockIdx.x][i] = gtime(); } while (0)
"""
ATTN_PHASES = ("start", "copies issued", "scores", "scores exchanged",
               "softmax", "memory in", "end")
GATE_PHASES = ("start", "copies issued", "x weights in", "x+h rows done",
               "ctx ready", "ctx in", "lanes summed", "pushed", "pair met",
               "end")
GROUP1_PHASES = ("inputs in", "x+h rows", "ctx rows", "lanes summed",
                 "warps summed", "pushed")
# (source text, text with stamps) per kernel file; each must match once.
ATTN_EDITS = [
    ("#pragma once\n", "#pragma once\n" + STAMPS),
    ("  const int j = (int)cluster.block_rank();\n",
     "  const int j = (int)cluster.block_rank();\n  ASTAMP(0);\n"),
    ("  griddep_launch_dependents();\n",
     "  griddep_launch_dependents();\n  ASTAMP(1);\n"),
    ("  cluster_arrive();\n  cluster_wait();  // all T",
     "  __syncthreads();\n  ASTAMP(2);\n  cluster_arrive();\n"
     "  cluster_wait();  // all T"),
    ("  if (warp == 0) {\n    float m",
     "  ASTAMP(3);\n  if (warp == 0) {\n    float m"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n\n  // Context",
     "  ASTAMP(4);\n  cp_async_wait<0>();\n  __syncthreads();\n  ASTAMP(5);\n"
     "\n  // Context"),
    ("    ctx[h_lo + h] = store_as<S>(acc);\n  }\n}",
     "    ctx[h_lo + h] = store_as<S>(acc);\n  }\n  __syncthreads();\n"
     "  ASTAMP(6);\n}"),
]
GATE_EDITS = [
    ("  const int rank = (int)cluster.block_rank();\n  const int j0",
     "  STAMP(0);\n  const int rank = (int)cluster.block_rank();\n"
     "  const int j0"),
    ("  for (int r0 = 0; r0 < B; r0 += kGateRows) {",
     "  STAMP(1);\n  for (int r0 = 0; r0 < B; r0 += kGateRows) {"),
    ("x weights\n      __syncthreads();\n",
     "x weights\n      __syncthreads();\n      STAMP(2);\n"),
    ("      griddep_wait();",
     "      STAMP(3);\n      griddep_wait();\n      STAMP(4);"),
    ("      __syncthreads();\n      fma_rows(acc[0], ws, xs, n, xh_steps, "
     "n_steps, rows, lane);\n    } else {",
     "      __syncthreads();\n      STAMP(5);\n      fma_rows(acc[0], ws, "
     "xs, n, xh_steps, n_steps, rows, lane);\n    } else {"),
    ("      __syncthreads();\n      if (kParts == 1) {",
     "      __syncthreads();\n      if (r0 == kGateRows) STAMP(10);\n"
     "      if (kParts == 1) {"),
    ("      }\n      fma_rows(acc[0], ws, xs, n, xh_steps, n_steps, rows, "
     "lane);\n    }",
     "      }\n      if (r0 == kGateRows) STAMP(11);\n"
     "      fma_rows(acc[0], ws, xs, n, xh_steps, n_steps, rows, lane);\n"
     "      if (r0 == kGateRows) STAMP(12);\n    }"),
    ("    for (int p = 0; p < kParts; ++p) sum_lanes_rows(acc[p], rows);\n",
     "    for (int p = 0; p < kParts; ++p) sum_lanes_rows(acc[p], rows);\n"
     "    if (r0 == 0) STAMP(6);\n    if (r0 == kGateRows) STAMP(13);\n"),
    ("    const int chunk_row0 = r0 % kChunkRows;\n",
     "    const int chunk_row0 = r0 % kChunkRows;\n"
     "    if (r0 == kGateRows) STAMP(14);\n"),
    ("    const int chunk_rows = chunk_row0 + rows;\n",
     "    const int chunk_rows = chunk_row0 + rows;\n"
     "    if (r0 == kGateRows) STAMP(15);\n"),
    ("      cluster_arrive();\n      cluster_wait();\n      if (owner) {",
     "      STAMP(7);\n      cluster_arrive();\n      cluster_wait();\n"
     "      STAMP(8);\n      if (owner) {"),
    ("this rank is done with its sums\n    }\n  }\n}",
     "this rank is done with its sums\n    }\n  }\n  __syncthreads();\n"
     "  STAMP(9);\n}"),
]
EXPORTS = """
extern "C" int phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
extern "C" int phases_attention(const float* q, const float* pm,
                                const float* mem, const float* v,
                                float* ctx, float* w, int B, int T, int A,
                                int H, int smem, void* stream) {
  return (int)launch_attention(q, pm, mem, v, ctx, w, B, T, A, H,
                               (size_t)smem, (cudaStream_t)stream);
}
"""


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"k2_phases: the kernel source changed; no "
                               f"single match for {old!r}")
        text = text.replace(old, new)
    return text


def build() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "attention.cuh").write_text(
        edited((_cuda.CSRC / "attention.cuh").read_text(), ATTN_EDITS))
    (out / "decode_cell.cu").write_text(
        edited((_cuda.CSRC / "decode_cell.cu").read_text(), GATE_EDITS)
        + EXPORTS)
    lib = out / "libphases.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(out), "-o",
                    str(lib), str(out / "decode_cell.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def stamps(lib) -> np.ndarray:
    buf = (ctypes.c_ulonglong * (1024 * 16))()
    _cuda.check(lib.phases_read(buf), "phases_read")
    return np.frombuffer(buf, dtype=np.uint64).reshape(1024, 16).astype(
        np.int64)


def report(tag: str, a: np.ndarray, gate_blocks: int, b: int) -> None:
    attn = a[ATTN_SLOT:ATTN_SLOT + 4, :len(ATTN_PHASES)]
    gate = a[:gate_blocks]
    t0 = attn[:, 0].min() if gate_blocks == 0 else min(
        attn[:, 0].min(), gate[:, 0].min())

    def us(v):
        return (v - t0) / 1e3

    print(f"B={b} {tag}: attention blocks ({', '.join(ATTN_PHASES)}) us: "
          + "; ".join(" ".join(f"{us(v):.2f}" for v in row) for row in attn))
    if gate_blocks == 0:
        return
    print(f"B={b} {tag}: gate phases median/min/max us: " + "; ".join(
        f"{name} {np.median(us(gate[:, i])):.2f}/{us(gate[:, i]).min():.2f}"
        f"/{us(gate[:, i]).max():.2f}" for i, name in enumerate(GATE_PHASES)))
    if b > 8:
        print(f"B={b} {tag}: second row group medians us: " + "; ".join(
            f"{name} {np.median(us(gate[:, 10 + i])):.2f}"
            for i, name in enumerate(GROUP1_PHASES)))


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_phases: needs a CUDA device", file=sys.stderr)
        return 1
    lib = build()
    fwd = lib.decode_cell_forward
    fwd.argtypes = _cuda.SIGNATURES["decode_cell"]["decode_cell_forward"]
    attn = lib.phases_attention
    attn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    for b in (1, 8, 40):
        gen = torch.Generator().manual_seed(0)

        def r(*shape):
            return torch.randn(*shape, generator=gen).cuda()

        x, c, h, q = r(b, E), r(b, H), r(b, H), r(b, A)
        pm, mem, v = r(b, T, A), r(b, T, H), r(A) / A ** 0.5
        w, bias = r(E + 2 * H, 4 * H) / (E + H) ** 0.5, 0.1 * r(4 * H)
        ctx, c_out, h_out = (torch.empty(b, H, device="cuda")
                             for _ in range(3))
        w_att = torch.empty(b, T, device="cuda")
        a_smem = attention_geometry(b, T, A, H)["smem_bytes"]
        gate = gate_geometry(b, E, H)

        def cell():
            _cuda.check(fwd(
                x.data_ptr(), c.data_ptr(), h.data_ptr(), q.data_ptr(),
                pm.data_ptr(), mem.data_ptr(), v.data_ptr(), w.data_ptr(),
                bias.data_ptr(), ctx.data_ptr(), c_out.data_ptr(),
                h_out.data_ptr(), b, T, E, A, H, a_smem,
                gate["smem_bytes"], torch.cuda.current_stream().cuda_stream),
                "decode_cell_forward")

        for _ in range(3):
            _cuda.check(attn(q.data_ptr(), pm.data_ptr(), mem.data_ptr(),
                             v.data_ptr(), ctx.data_ptr(), w_att.data_ptr(),
                             b, T, A, H, a_smem,
                             torch.cuda.current_stream().cuda_stream),
                        "phases_attention")
        torch.cuda.synchronize()
        report("K1 alone", stamps(lib), 0, b)
        for _ in range(5):
            cell()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(4):
                cell()
        for tag in ("K2 graph replay", "K2 eager"):
            for _ in range(3):
                if tag == "K2 eager":
                    for _ in range(4):
                        cell()
                else:
                    graph.replay()
                torch.cuda.synchronize()
            report(tag, stamps(lib), gate["blocks"], b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
