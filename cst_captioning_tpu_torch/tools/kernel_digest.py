"""SHA-256 digests of the float32 kernels' outputs on seeded inputs, so
that the kernels of two checkouts can be compared bit for bit on one
card.

    python cst_captioning_tpu_torch/tools/kernel_digest.py --root CHECKOUT

imports ``cst_captioning_tpu_torch`` from ``CHECKOUT`` (default: the
checkout this file lies in), builds its kernels, runs K1 at B in 1, 8,
40, 1280 and K2 at B in 1, 8, 40, 1344 (T = 29, E = H = A = 512) in
float32 storage on inputs drawn from a fixed seed, and prints one JSON
line ``{"K1/1": digest, ...}`` of the outputs' bytes.  Two checkouts whose
lines are equal computed the same bits.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

T, E, H, A = 29, 512, 512, 512


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_digest: needs a CUDA device", file=sys.stderr)
        return 1
    from cst_captioning_tpu_torch.ops import attention_kernel as k1
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:32]

    out = {}
    for b in (1, 8, 40, 1280, 1344):
        gen = torch.Generator().manual_seed(b)

        def r(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen)).cuda()

        q, pm, mem, v = r(b, A), r(b, T, A), r(b, T, H), r(A, scale=A ** -.5)
        x, c, h = r(b, E), r(b, H), torch.tanh(r(b, H))
        w, bias = r(E + 2 * H, 4 * H, scale=(E + H) ** -.5), r(4 * H,
                                                               scale=0.1)
        with torch.no_grad():
            if b != 1344:
                out[f"K1/{b}"] = digest(k1.fused_additive_attention(
                    q, pm, mem, v))
            if b != 1280:
                out[f"K2/{b}"] = digest(k2.fused_decode_cell(
                    x, c, h, q, pm, mem, v, w, bias))
    torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
