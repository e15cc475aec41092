#!/usr/bin/env python3
"""Where K8 and K9 and their plain versions round differently, against fp64.

    python3 tools/paged_rounding.py [all | k9 CASE E4M3 | k8 CASE E4M3]

With no argument (or `all`) it takes every case of the K9 card test
(tests/test_torch_cuda.py's K9_CASES, over pools of q's type and over e4m3
pools scaled by 4) and every case of the K8 card tests (PAGED_CASES at
each of their steps, the same two pools), runs the kernel and its plain
version on the card, and the same attention in fp64 from the same inputs:
the plain version with every fp32 cast made an fp64 one. It prints a line
per case with how many outputs the kernel and the plain version each put
off the fp64 result rounded to q's type, how many the two differ at and
by how much at most, how many outputs pass the capped bound the card tests
held them to before (`_paged_tol_capped`) and by how many ulps of q's type
at the plain value at most, and how many pass the card tests' bound
(`_paged_tol`). `k9 5 1` takes one
case (K9's case 5 over e4m3 pools) and also prints its three largest
kernel-plain differences beside the fp64 values. Needs a card."""

import contextlib
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


@contextlib.contextmanager
def _fp64_casts():
    """The plain versions cast to fp32 with Tensor.float: make that fp64."""
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = cast


def _fp64(plain, args):
    dbl = tuple(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
                else a for a in args)
    with _fp64_casts():
        return plain(*dbl)


def _k9_calls(i, e4m3):
    D, dtype, G, Nk, bs, MB, n_blocks, lengths, starts, inactive, window, poison = \
        tc.K9_CASES[i]
    q, kp, vp, tables, lens, sts, _, _ = tc._paged_case(
        dev, D, dtype, G, Nk, bs, MB, n_blocks, 1, lengths, starts, inactive, poison)
    if e4m3:
        kp, vp = tc._e4m3(kp.float()), tc._e4m3(vp.float())
    for layer in range(kp.shape[0]):
        yield (dtype, pa.paged_decode, pa.paged_decode_plain,
               (q, kp[layer], vp[layer], tables, lens, sts, D ** -0.5, window))


def _k8_calls(i, e4m3):
    D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, steps, window, \
        poison = tc.PAGED_CASES[i]
    if e4m3:   # as test_paged_decode_frozen_e4m3_matches_plain
        q, kp, vp, tables, lens, sts, ki, vi = tc._paged_case(
            dev, D, torch.float32, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive,
            poison)
        q, kp, vp, ki, vi = q.to(dtype), tc._e4m3(kp), tc._e4m3(vp), ki.bfloat16(), \
            vi.bfloat16()
    else:
        q, kp, vp, tables, lens, sts, ki, vi = tc._paged_case(
            dev, D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, poison)
    for step in steps:
        for layer in range(kp.shape[0]):
            yield (dtype, pa.paged_decode_frozen, pa.paged_decode_frozen_plain,
                   (q, kp, vp, tables, lens, sts, ki, vi, layer, step, D ** -0.5, window))


def run(name, calls, k, detail=False):
    n = kp_diff = k_off = p_off = over_old = over_new = 0
    worst_ulps, worst = 0.0, 0.0
    for dtype, kern, plain, args in calls:
        got = kern(*args).float()
        want = plain(*args).float()
        ex = _fp64(plain, args)
        exr = ex.to(dtype).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        ulp = tc._ulp(want, dtype)
        old = k * tc._paged_tol_capped(dtype, want)
        n += got.numel()
        kp_diff += int((got != want).sum())
        k_off += int((got != exr).sum())
        p_off += int((want != exr).sum())
        over = err > old
        over_old += int(over.sum())
        over_new += int((err > tc._paged_tol(dtype, want, k)).sum())
        if bool(over.any()):
            worst_ulps = max(worst_ulps, (err[over] / ulp[over]).max().item())
        worst = max(worst, err.max().item())
        if detail:
            for i in err.flatten().topk(3).indices.tolist():
                at = torch.unravel_index(torch.tensor(i), got.shape)
                print(f"   at {tuple(int(x) for x in at)}: kernel {got[at].item()} plain "
                      f"{want[at].item()} fp64 {ex[at].item():.9f}")
    print(f"{name}: {n} outputs; off fp64 rounded: kernel {k_off}, plain {p_off}; kernel "
          f"!= plain at {kp_diff}, largest {worst}; over the capped bound {over_old} (at "
          f"most {worst_ulps:g} ulp of the plain value), over the bound {over_new}",
          flush=True)


def main(argv):
    if len(argv) >= 3:
        fam, i, e4m3 = argv[0], int(argv[1]), bool(int(argv[2]))
        calls = (_k9_calls if fam == "k9" else _k8_calls)(i, e4m3)
        k = 4 if fam == "k8" and e4m3 else 1
        run(f"{fam} case {i}{' e4m3' if e4m3 else ''}", calls, k, detail=True)
        return
    # the K8 e4m3 test holds its kernel to 4x the bound; the others to 1x
    for e4m3 in (False, True):
        for i in range(len(tc.K9_CASES)):
            run(f"k9 case {i}{' e4m3' if e4m3 else ''}", _k9_calls(i, e4m3), 1)
    for e4m3 in (False, True):
        for i in range(len(tc.PAGED_CASES)):
            run(f"k8 case {i}{' e4m3' if e4m3 else ''}", _k8_calls(i, e4m3),
                4 if e4m3 else 1)


if __name__ == "__main__":
    main([a for a in sys.argv[1:] if a != "all"])
