"""K2's times on the card for a checkout, so that two checkouts can be
compared in one call.

    python cst_captioning_tpu_torch/tools/k2_times.py --root CHECKOUT

imports ``cst_captioning_tpu_torch`` from ``CHECKOUT`` (default: the
checkout this file lies in), builds its kernels and prints one JSON line
``{"float32/1": ms, ..., "bfloat16/T2/1344": ms}``: K2
(``fused_decode_cell``) in each storage dtype at B in 1, 8, 40, 320, 1344
(T = 29, E = H = A = 512) and at T = 2 with B = 1344, each the median of
``--reps`` CUDA-graph replays of 20 calls, on inputs drawn from a fixed
seed.  Compare two checkouts in turns (parent, change, change, parent)
within one call.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

T, E, H, A = 29, 512, 512, 512
BATCHES = (1, 8, 40, 320, 1344)


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[len(times) // 2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("k2_times: needs a CUDA device", file=sys.stderr)
        return 1
    from cst_captioning_tpu_torch.ops import _cuda
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    _cuda.build()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "float32" if dtype == torch.float32 else "bfloat16"
        for b, t in [(b, T) for b in BATCHES] + [(BATCHES[-1], 2)]:
            gen = torch.Generator().manual_seed(b)

            def r(*shape, scale=1.0):
                return (scale * torch.randn(*shape, generator=gen)).cuda()

            x, c, h, q = r(b, E), r(b, H), torch.tanh(r(b, H)), r(b, A)
            pm, mem, v = r(b, t, A), r(b, t, H), r(A, scale=A ** -0.5)
            w, bias = r(E + 2 * H, 4 * H, scale=(E + H) ** -0.5), r(
                4 * H, scale=0.1)
            cell = [x, c, h, q, pm, mem, v, w, bias]
            cell = [a if i == 6 else a.to(dtype) for i, a in enumerate(cell)]
            key = f"{name}/{b}" if t == T else f"{name}/T2/{b}"
            with torch.no_grad():
                out[key] = graph_ms(lambda: k2.fused_decode_cell(*cell),
                                    reps=args.reps)
    print(json.dumps({"root": os.path.abspath(args.root), "k2_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
