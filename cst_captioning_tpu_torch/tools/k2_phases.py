"""Phase timeline of the K2 and K1 kernels on the card.

    python -m cst_captioning_tpu_torch.tools.k2_phases [--batches 1,8,40,320,1344]

Builds a copy of ``csrc/decode_cell.cu`` and ``csrc/attention.cuh`` in
which thread 0 of each block writes the device clock (``%globaltimer``,
ns) at the boundaries of the kernels' phases, and runs, in each storage
dtype (float32, bfloat16) and at each batch (T = 29, E = H = A = 512; and
T = 2 at the largest batch), K1 alone and then K2 four times in a row
(CUDA graph replay, then eager launches), the stamps cleared before the
fourth call.  It prints the mean times (CUDA events over 50 launches) of
K2, of its gate launch alone (no programmatic dependent launch, ctx
ready) and of K1 alone; then, in microseconds from the first block's
start of the fourth call: the phases of the first row's attention blocks, and the median
/ min / max over the gate blocks of each gate phase of whichever gate
kernel the wrapper's ``gate_geometry`` picks (``gate_kernel``,
``gate_tile_kernel`` or ``gate_mma_kernel``): its start, the prologue's
copies issued, the first ctx tile's wait entered and left (the attention
launch done), marks A and B (a third and two thirds of the block's
tiles; in ``gate_kernel`` of the rank's chunk, in ``gate_mma_kernel`` A
is the h side done and B half the input side), the loop done, the end.  The stamps cost a few instructions each; the
kernels' own times are ``chip_smoke.py``'s.  Refuses to build when the
kernel sources no longer match its edit anchors.  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from cst_captioning_tpu_torch.ops import _cuda
from cst_captioning_tpu_torch.ops.attention_kernel import attention_geometry
from cst_captioning_tpu_torch.ops.decode_cell_kernel import (LAUNCHERS,
                                                             gate_geometry)

T, E, H, A = 29, 512, 512, 512
SLOTS = 2048                # stamp rows
ATTN_SLOT = 1536            # stamp rows of the attention blocks of row 0
STAMPS = """
__device__ unsigned long long g_stamps[2048][16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define GSTAMP(i) do { const unsigned _b = blockIdx.y * gridDim.x + \\
  blockIdx.x; if (threadIdx.x == 0 && _b < 1536) \\
  g_stamps[_b][i] = gtime(); } while (0)
#define GSTAMP_FIRST(i) do { const unsigned _b = blockIdx.y * gridDim.x + \\
  blockIdx.x; if (threadIdx.x == 0 && _b < 1536 && g_stamps[_b][i] == 0) \\
  g_stamps[_b][i] = gtime(); } while (0)
#define ASTAMP(i) do { if (blockIdx.y == 0 && threadIdx.x == 0) \\
  g_stamps[1536 + blockIdx.x][i] = gtime(); } while (0)
"""
ATTN_PHASES = ("start", "copies issued", "scores", "scores exchanged",
               "softmax", "memory in", "end")
GATE_PHASES = ("start", "prologue issued", "ctx wait entered",
               "ctx wait left", "mark A", "mark B", "loop done", "end")
# (source text, text with stamps); each must match once.
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
WAIT = ("    if (k.ctx) griddep_wait();  // ctx comes from the attention "
        "launch\n",
        "    if (k.ctx) {\n      GSTAMP_FIRST(2);\n      griddep_wait();\n"
        "      GSTAMP_FIRST(3);\n    }\n")
F32_END = ("      lstm_f32(g, c[idx], c_out + idx, h_out + idx);\n    }\n"
           "  }\n}\n",
           "      lstm_f32(g, c[idx], c_out + idx, h_out + idx);\n    }\n"
           "  }\n  __syncthreads();\n  GSTAMP(7);\n}\n")
# The gate kernels' edits, each within its section of decode_cell.cu (the
# text between the "// ----" rulers): gate_kernel, gate_tile_kernel,
# gate_mma_kernel.
GATE_EDITS = {
    "gate_kernel": [
        ("  cluster_arrive();  // this block runs: its peers may write to "
         "it\n",
         "  GSTAMP(0);\n  cluster_arrive();  // this block runs: its peers "
         "may write to it\n"),
        ("  for (int m = 0; m < mine; ++m) {\n",
         "  GSTAMP(1);\n  for (int m = 0; m < mine; ++m) {\n"
         "    if (m == mine / 3) GSTAMP(4);\n"
         "    if (m == 2 * mine / 3) GSTAMP(5);\n"),
        ("      griddep_wait();\n      ctx_ready = true;\n",
         "      GSTAMP_FIRST(2);\n      griddep_wait();\n"
         "      GSTAMP_FIRST(3);\n      ctx_ready = true;\n"),
        ("  cluster_wait();  // every peer runs\n",
         "  GSTAMP(6);\n  cluster_wait();  // every peer runs\n"),
        ("      lstm_bf16(sums[1], sums[0], b, c_old, c_out + idx, h_out + "
         "idx);\n    }\n  }\n}\n",
         "      lstm_bf16(sums[1], sums[0], b, c_old, c_out + idx, h_out + "
         "idx);\n    }\n  }\n  __syncthreads();\n  GSTAMP(7);\n}\n")],
    "gate_tile_kernel": [
        ("  const int tr = (tid >> 5) * 2 + (lane >> 4);  // rows 4 tr .. 4 "
         "tr + 3\n",
         "  const int tr = (tid >> 5) * 2 + (lane >> 4);  // rows 4 tr .. 4 "
         "tr + 3\n  GSTAMP(0);\n"),
        WAIT,
        ("  for (int p = 0; p < side.n; ++p) {\n"
         "    cp_async_wait<Sh::kStages - 2>();  // tile p\n",
         "  GSTAMP(1);\n  for (int p = 0; p < side.n; ++p) {\n"
         "    cp_async_wait<Sh::kStages - 2>();  // tile p\n"
         "    if (p == side.n / 3) GSTAMP(4);\n"
         "    if (p == 2 * side.n / 3) GSTAMP(5);\n"),
        ("#pragma unroll\n  for (int i = 0; i < 4; ++i) {\n"
         "    const int r = 4 * tr + i;\n",
         "  GSTAMP(6);\n#pragma unroll\n  for (int i = 0; i < 4; ++i) {\n"
         "    const int r = 4 * tr + i;\n"),
        F32_END],
    "gate_mma_kernel": [
        ("  const int wrow = wm * 16 * MT;  // the warp's first row of the "
         "tile\n",
         "  const int wrow = wm * 16 * MT;  // the warp's first row of the "
         "tile\n  GSTAMP(0);\n"),
        WAIT,
        ("  for (int p = 0; p < hs.n; ++p) run(p, h_walk, true);\n",
         "  GSTAMP(1);\n  for (int p = 0; p < hs.n; ++p) run(p, h_walk, true);"
         "\n  GSTAMP(4);\n"),
        ("  for (int p = hs.n; p < n; ++p) run(p, in_walk, false);\n",
         "  for (int p = hs.n; p < n; ++p) {\n"
         "    if (p == hs.n + is.n / 2) GSTAMP(5);\n"
         "    run(p, in_walk, false);\n  }\n  GSTAMP(6);\n"),
        ("                  h_out + idx);\n      }\n    }\n}\n",
         "                  h_out + idx);\n      }\n    }\n"
         "  __syncthreads();\n  GSTAMP(7);\n}\n")],
}
RULER = "// " + "-" * 75 + "\n"
EXPORTS = """
extern "C" int phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
extern "C" int phases_clear(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_stamps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemsetAsync(p, 0, sizeof(g_stamps), (cudaStream_t)stream);
}
template <typename S>
static int gate_alone(const S* x, const S* c, const S* h, const S* w,
                      const S* bias, const S* ctx, S* c_out, S* h_out, int B,
                      int E, int H, int variant, int smem, void* stream) {
  GateLaunch g;
  if (!gate_launch_shape<S>(variant, E, H, &g) || (size_t)smem != g.smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_gate(g.kernel, g.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x,    (void*)&ctx, (void*)&h,     (void*)&w,
                  (void*)&bias, (void*)&c,   (void*)&c_out, (void*)&h_out,
                  (void*)&B,    (void*)&E,   (void*)&H};
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      gate_config(g, B, H, (cudaStream_t)stream, false, attr);
  return (int)cudaLaunchKernelExC(&cfg, g.kernel, args);
}
extern "C" int phases_gate(int elem, const void* x, const void* c,
                           const void* h, const void* w, const void* bias,
                           const void* ctx, void* c_out, void* h_out, int B,
                           int E, int H, int variant, int smem,
                           void* stream) {
  if (elem == 4)
    return gate_alone((const float*)x, (const float*)c, (const float*)h,
                      (const float*)w, (const float*)bias, (const float*)ctx,
                      (float*)c_out, (float*)h_out, B, E, H, variant, smem,
                      stream);
  return gate_alone((const __nv_bfloat16*)x, (const __nv_bfloat16*)c,
                    (const __nv_bfloat16*)h, (const __nv_bfloat16*)w,
                    (const __nv_bfloat16*)bias, (const __nv_bfloat16*)ctx,
                    (__nv_bfloat16*)c_out, (__nv_bfloat16*)h_out, B, E, H,
                    variant, smem, stream);
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


def edited_gates(text: str) -> str:
    """decode_cell.cu with each gate kernel's stamps, each kernel's edits
    applied within its own section."""
    parts = text.split(RULER)
    for name, edits in GATE_EDITS.items():
        hits = [i for i, p in enumerate(parts)
                if f"__global__ void" in p and f" {name}(" in p]
        if len(hits) != 1:
            raise RuntimeError(f"k2_phases: the kernel source changed; "
                               f"{len(hits)} sections define {name}")
        parts[hits[0]] = edited(parts[hits[0]], edits)
    return RULER.join(parts)


def build() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "attention.cuh").write_text(
        edited((_cuda.CSRC / "attention.cuh").read_text(), ATTN_EDITS))
    (out / "decode_cell.cu").write_text(
        edited_gates((_cuda.CSRC / "decode_cell.cu").read_text()) + EXPORTS)
    lib = out / "libphases.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(out), "-o",
                    str(lib), str(out / "decode_cell.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def stamps(lib) -> np.ndarray:
    buf = (ctypes.c_ulonglong * (SLOTS * 16))()
    _cuda.check(lib.phases_read(buf), "phases_read")
    return np.frombuffer(buf, dtype=np.uint64).reshape(SLOTS, 16).astype(
        np.int64)


def report(tag: str, a: np.ndarray, gate: dict) -> None:
    attn = a[ATTN_SLOT:ATTN_SLOT + 4, :len(ATTN_PHASES)]
    blocks = a[:min(gate["blocks"], ATTN_SLOT) if gate else 0]
    starts = [attn[:, 0].min()] + ([blocks[:, 0].min()] if gate else [])
    t0 = min(s for s in starts if s > 0)

    def us(v):
        return (v - t0) / 1e3

    print(f"{tag}: attention blocks of row 0 ({', '.join(ATTN_PHASES)}) us: "
          + "; ".join(" ".join(f"{us(v):.2f}" for v in row) for row in attn))
    if not gate:
        return
    cols = []
    for i, name in enumerate(GATE_PHASES):
        v = blocks[:, i]
        v = v[v > 0]
        cols.append(f"{name} " + (f"{np.median(us(v)):.2f}/{us(v).min():.2f}"
                                  f"/{us(v).max():.2f}" if len(v) else "-"))
    print(f"{tag}: {gate['kernel']} (variant {gate['variant']}, "
          f"{gate['blocks']} blocks) phases median/min/max us: "
          + "; ".join(cols))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def mean_us(fn, n: int = 50) -> float:
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", default="1,8,40,320,1344")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_phases: needs a CUDA device", file=sys.stderr)
        return 1
    lib = build()
    attn = lib.phases_attention
    attn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.phases_clear.argtypes = [ctypes.c_void_p]
    lib.phases_gate.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    batches = [int(b) for b in args.batches.split(",")]
    runs = [(b, T) for b in batches] + [(batches[-1], 2)]
    for store in (torch.float32, torch.bfloat16):
        fwd = getattr(lib, LAUNCHERS[store])
        fwd.argtypes = _cuda.SIGNATURES["decode_cell"][LAUNCHERS[store]]
        elem = torch.tensor([], dtype=store).element_size()
        for b, t in runs:
            gen = torch.Generator().manual_seed(0)

            def r(*shape, scale=1.0):
                return (scale * torch.randn(*shape, generator=gen)).cuda()

            x, c, h, q = r(b, E), r(b, H), r(b, H), r(b, A)
            pm, mem, v = r(b, t, A), r(b, t, H), r(A, scale=A ** -0.5)
            w, bias = r(E + 2 * H, 4 * H, scale=(E + H) ** -0.5), r(
                4 * H, scale=0.1)
            ctx, c_out, h_out = (torch.empty(b, H, device="cuda")
                                 for _ in range(3))
            w_att = torch.empty(b, t, device="cuda")
            a_smem = attention_geometry(b, t, A, H)["smem_bytes"]
            if store == torch.bfloat16:
                x, c, h, q, pm, mem, w, bias, ctx, c_out, h_out = (
                    z.to(store) for z in (x, c, h, q, pm, mem, w, bias, ctx,
                                          c_out, h_out))
            gate = gate_geometry(b, E, H, elem)
            k2_attn_smem = attention_geometry(b, t, A, H, elem)["smem_bytes"]

            def cell():
                _cuda.check(fwd(
                    x.data_ptr(), c.data_ptr(), h.data_ptr(), q.data_ptr(),
                    pm.data_ptr(), mem.data_ptr(), v.data_ptr(),
                    w.data_ptr(), bias.data_ptr(), ctx.data_ptr(),
                    c_out.data_ptr(), h_out.data_ptr(), b, t, E, A, H,
                    k2_attn_smem, gate["variant"], gate["smem_bytes"],
                    stream()),
                    LAUNCHERS[store])

            def four():
                for _ in range(3):
                    cell()
                _cuda.check(lib.phases_clear(stream()), "phases_clear")
                cell()

            def gate_alone():
                _cuda.check(lib.phases_gate(
                    elem, x.data_ptr(), c.data_ptr(), h.data_ptr(),
                    w.data_ptr(), bias.data_ptr(), ctx.data_ptr(),
                    c_out.data_ptr(), h_out.data_ptr(), b, E, H,
                    gate["variant"], gate["smem_bytes"], stream()),
                    "phases_gate")

            name = f"{'float32' if elem == 4 else 'bfloat16'} B={b} T={t}"
            print(f"{name} times us: K2 {mean_us(cell):.2f}, its gate launch "
                  f"alone {mean_us(gate_alone):.2f} ({gate['kernel']}, "
                  f"variant {gate['variant']})", flush=True)
            if elem == 4:
                def k1_alone():
                    _cuda.check(attn(
                        q.data_ptr(), pm.data_ptr(), mem.data_ptr(),
                        v.data_ptr(), ctx.data_ptr(), w_att.data_ptr(), b, t,
                        A, H, a_smem, stream()), "phases_attention")

                k1_us = mean_us(k1_alone)
                _cuda.check(lib.phases_clear(stream()), "phases_clear")
                k1_alone()
                torch.cuda.synchronize()
                report(f"{name} K1 alone ({k1_us:.2f} us)", stamps(lib), {})
            for _ in range(3):
                four()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                four()
            for tag in ("K2 graph replay", "K2 eager"):
                for _ in range(3):
                    graph.replay() if tag == "K2 graph replay" else four()
                    torch.cuda.synchronize()
                report(f"{name} {tag}", stamps(lib), gate)
    return 0


if __name__ == "__main__":
    sys.exit(main())
