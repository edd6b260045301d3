"""The work counts copied into the benchmark, against hand-computed
operations and bytes at one small shape of each kernel, and against the
port's own counts at the serving lanes the cells run."""
import math

import pytest
import torch

from bench.lib import slicework, work


def test_bc_fused_by_hand():
    # B=2 rows, p=3 x q=2 blocks of k=8: kf=5
    flops, nbytes = work.bc_fused(2, 3, 2, 8)
    fft = 2.5 * 8 * 3            # 2.5 k log2 k a transform
    assert flops == pytest.approx(fft * 2 * 2 + fft * 2 * 3
                                  + 6 * 2 * 3 * 2 * 5 + 2 * 2 * 5
                                  + 2 * 2 * 3 * 5)
    assert nbytes == 4 * (2 * 2 * 8 + 2 * 3 * 8) + 3 * 3 * 2 * 4 * 5


def test_bc_grad_w_by_hand():
    flops, nbytes = work.bc_grad_w(4, 3, 2, 8)
    fft = 2.5 * 8 * 3
    assert flops == pytest.approx(fft * 12 + fft * 8 + 6 * 4 * 3 * 2 * 5
                                  + 4 * 3 * 5 + 2 * 4 * 2 * 5
                                  + 2 * 3 * 2 * 5 + fft * 6)
    assert nbytes == 4 * (4 * 3 * 8 + 4 * 2 * 8 + 3 * 2 * 8)


def test_flash_by_hand():
    # S=3 causal: 6 pairs; 4 query heads, 2 KV heads of 16, bf16
    flops, nbytes = work.flash(3, 4, 2, 16, 2)
    assert flops == 4 * 16 * 4 * 6
    assert nbytes == 2 * 3 * 16 * (2 * 4 + 2 * 2)


def test_paged_by_hand():
    flops, nbytes = work.paged([5, 2], 4, 2, 16, 2, 2)
    assert flops == 4 * 4 * 16 * 7
    assert nbytes == 2 * 7 * 2 * 16 * 2 + 2 * 2 * 4 * 16 * 2


def test_the_ports_counts_agree_where_nothing_is_padding():
    from repro_torch.kernels import bc_fused, bc_grad_w, flash_attention
    w = bc_fused.work(1, 16, 20, 32, 128, "bc_fused")
    assert (w.flops, w.nbytes) == pytest.approx(work.bc_fused(16, 20, 32,
                                                              128))
    g = bc_grad_w.work(64, 20, 32, 128)
    assert (g.flops, g.nbytes) == pytest.approx(work.bc_grad_w(64, 20, 32,
                                                               128))
    f = flash_attention.work(1, 32, 8, 100, 100, 128, torch.bfloat16)
    assert (f.flops, f.nbytes) == pytest.approx(work.flash(100, 32, 8, 128,
                                                           2))


def test_least_time_and_slice_work():
    pk = {"flops_per_s": 1e12, "bytes_per_s": 1e9}
    assert work.least_s(2e12, 1e9, pk) == 2.0
    assert work.least_s(1e9, 3e9, pk) == 3.0
    steps = [{"prefills": [10], "decode": [(11, 2), (40, 1)]},
             {"prefills": [], "decode": [(13, 1)]}]
    assert list(slicework.prefills(steps)) == [10]
    assert list(slicework.decode_steps(steps)) == [[11, 40], [12], [13]]
    cfg = {"hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 100,
           "vocab_multiple": 128,
           "block_circulant": {"block_attn": 16, "block_ffn": 16}}
    proj = work.projection_flops_per_token(cfg)
    head = 2.0 * 64 * 128
    att = 2 * 4.0 * 4 * 16
    want = (10 * proj + att * 55 + head
            + 2 * (proj + head) + att * 51 + 2 * (proj + head) + att * 25)
    assert slicework.model_flops(cfg, steps) == pytest.approx(want)
    assert proj == pytest.approx(2 * sum(
        2.5 * (n_in // 16 + n_out // 16) * 16 * 4
        + 6 * (n_in // 16) * (n_out // 16) * 9
        for n_in, n_out in [(64, 64), (64, 32), (64, 32), (64, 64),
                            (64, 128), (64, 128), (128, 64)]))
    assert math.isclose(work.head_flops(cfg), head)
