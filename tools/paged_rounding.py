#!/usr/bin/env python3
"""Where K9 and its plain version round differently, against fp64.

    python3 tools/paged_rounding.py [CASE]

Takes the K9 card test's case CASE (index into tests/test_torch_cuda.py's
K9_CASES, default 5: G = 16 over e4m3 pools) with its e4m3 pools, runs K9
and the plain version on the card, and the same attention in fp64 from the
same inputs; prints, per layer, how many outputs each differs at from the
fp64 result rounded to q's type, and the largest kernel-plain
disagreements beside the fp64 values. Needs a card."""

import os
import sys

import torch

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
sys.path.insert(0, os.path.join(here, "tests"))
import test_torch_cuda as tc  # noqa: E402

from tinygpt_tpu_torch.ops import paged_attention as pa  # noqa: E402

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
case = tc.K9_CASES[int(sys.argv[1]) if len(sys.argv) > 1 else 5]
D, dtype, G, Nk, bs, MB, n_blocks, lengths, starts, inactive, window, poison = case
q, kp, vp, tables, lens, sts, _, _ = tc._paged_case(dev, D, dtype, G, Nk, bs, MB, n_blocks, 1,
                                                    lengths, starts, inactive, poison)
kp, vp = tc._e4m3(kp.float()), tc._e4m3(vp.float())
B = q.shape[0]
for layer in range(kp.shape[0]):
    args = (q, kp[layer], vp[layer], tables, lens, sts, D ** -0.5, window)
    got = pa.paged_decode(*args).float()
    want = pa.paged_decode_plain(*args).float()
    k = pa.paged_gather_dense(kp[layer], tables).double()
    v = pa.paged_gather_dense(vp[layer], tables).double()
    t = torch.arange(k.shape[2], device=dev)[None]
    mask = (t < lens[:, None]) & (t >= sts[:, None])
    if window:
        mask = mask & (t > lens[:, None] - 1 - window)
    s = torch.einsum("bkgd,bktd->bkgt", q.double().reshape(B, Nk, G, D), k) * D ** -0.5
    p = torch.softmax(s.masked_fill(~mask[:, None, None], -1e300), -1)
    ex = torch.einsum("bkgt,bktd->bkgd", p, torch.where(mask[:, None, :, None], v, 0.0))
    ex = ex.reshape(got.shape)
    exr = ex.to(dtype).float()
    print(f"layer {layer}: kernel and plain differ at {int((got != want).sum())} outputs "
          f"(largest {(got - want).abs().max().item()}); kernel against fp64 rounded: "
          f"{int((got != exr).sum())} (largest {(got - exr).abs().max().item()}); plain "
          f"against fp64 rounded: {int((want != exr).sum())} (largest "
          f"{(want - exr).abs().max().item()})")
    for i in (got - want).abs().flatten().topk(3).indices.tolist():
        at = torch.unravel_index(torch.tensor(i), got.shape)
        print(f"   at {tuple(int(x) for x in at)}: kernel {got[at].item()} plain "
              f"{want[at].item()} fp64 {ex[at].item():.9f}")
