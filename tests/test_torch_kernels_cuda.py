"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import attention_kernel as k1
from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2
from cst_captioning_tpu_torch.ops import launch_counts, reset_launch_counts
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.serving.engine import serve_decode_batch
from cst_captioning_tpu_torch.weights import init_random_

pytestmark = pytest.mark.cuda

T, E, H, A = 29, 512, 512, 512        # the serving shapes (MSR-VTT width)
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _attention_inputs(b, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, A, generator=g), torch.randn(b, T, A, generator=g),
            torch.randn(b, T, H, generator=g),
            torch.randn(A, generator=g) / A ** 0.5)


@pytest.mark.parametrize("b", [1, 8, 40])
def test_attention_kernel_matches_plain(cuda, b):
    args = [a.to(cuda) for a in _attention_inputs(b, b)]
    before = k1.fused_additive_attention.launches
    ctx, w = k1.fused_additive_attention(*args)
    torch.cuda.synchronize()
    assert k1.fused_additive_attention.launches == before + 1
    ref_ctx, ref_w = k1.additive_attention_plain(*args)
    assert (ctx - ref_ctx).abs().max().item() <= TOL
    assert (w - ref_w).abs().max().item() <= TOL


@pytest.mark.parametrize("b", [1, 8, 40])
def test_decode_cell_kernel_matches_plain(cuda, b):
    g = torch.Generator().manual_seed(100 + b)
    q, pm, mem, v = _attention_inputs(b, b)
    args = [t.to(cuda) for t in (
        torch.randn(b, E, generator=g), torch.randn(b, H, generator=g),
        torch.tanh(torch.randn(b, H, generator=g)), q, pm, mem, v,
        torch.randn(E + 2 * H, 4 * H, generator=g) / (E + H) ** 0.5,
        0.1 * torch.randn(4 * H, generator=g))]
    before = k2.fused_decode_cell.launches
    c, h = k2.fused_decode_cell(*args)
    torch.cuda.synchronize()
    assert k2.fused_decode_cell.launches == before + 2
    ref_c, ref_h = k2.decode_cell_plain(*args)
    assert (c - ref_c).abs().max().item() <= TOL
    assert (h - ref_h).abs().max().item() <= TOL


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, pm, mem, v = (a.to(cuda) for a in _attention_inputs(4, 0))
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_additive_attention(q, pm.transpose(1, 2).contiguous()
                                    .transpose(1, 2), mem, v)
    with pytest.raises(ValueError, match="several devices"):
        k1.fused_additive_attention(q.cpu(), pm, mem, v)
    with pytest.raises(TypeError, match="float32"):
        k1.fused_additive_attention(q.half(), pm, mem, v)


def test_served_greedy_captions_equal_offline_on_card(cuda):
    model = CaptionModel(64, [32, 16], embed_size=32, hidden_size=32,
                         attn_size=32, decode_kernel="fused")
    init_random_(model, 0, eos_bias=0.3)
    model = model.eval().to(cuda)
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((6, 5, 32), dtype=np.float32),
             rng.standard_normal((6, 1, 16), dtype=np.float32)]
    reset_launch_counts()
    served = serve_decode_batch(model, [[f[i] for f in feats]
                                        for i in range(6)], 12,
                                decode_chunk=4, bucket_sizes=(1, 4))
    assert launch_counts()["fused_decode_cell"] > 0
    offline = greedy_decode(model, [torch.from_numpy(f).to(cuda)
                                    for f in feats], 12, decode_chunk=4)
    np.testing.assert_array_equal(np.stack(served), offline.cpu().numpy())
