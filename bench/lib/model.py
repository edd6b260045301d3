"""The configuration as the benchmark runs it: the weights it makes from
the seed, and the port's ``ArchConfig`` built from the configuration file.

The benchmark makes every weight itself, on the device, from the seed, in
one ``torch.randn`` call over a flat buffer: the layout (``weight_plan``)
comes from the configuration file, not from the program.  The program
gets a copy (``load_into``); the plain reference gets the same buffer made
again from the same seed once the program's state is freed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from . import work

# the norm scales are drawn N(0, NORM_STD^2) around the port's 1 + scale
NORM_STD = 0.1


def weight_plan(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """Every weight of a decoder LM with block-circulant projections, in
    the order the flat buffer holds them: (name, shape, scale).  Names
    are the port's parameter names; ``load_into`` checks that the
    program has exactly these."""
    d = cfg["hidden_size"]
    D = work.head_dim(cfg)
    plan = [("embed.table", (work.padded_vocab(cfg), d), d ** -0.5)]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"blocks.{i}."
        plan.append((pre + "ln1.scale", (d,), NORM_STD))
        plan.append((pre + "ln2.scale", (d,), NORM_STD))
        for name, (n_in, n_out) in work.projections(cfg).items():
            k = work.block_of(cfg, name)
            owner = "attn" if name in ("q", "k", "v", "o") else "mlp"
            plan.append((f"{pre}{owner}.{name}.wc",
                         (work.blocks(n_out, k), work.blocks(n_in, k), k),
                         1.0 / math.sqrt(n_in)))
        if cfg.get("qk_norm"):
            plan.append((pre + "attn.qn.scale", (D,), NORM_STD))
            plan.append((pre + "attn.kn.scale", (D,), NORM_STD))
    plan.append(("final_norm.scale", (d,), NORM_STD))
    return plan


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed``: one draw of N(0, 1)
    float32 over a flat buffer on ``device``, each weight a scaled view of
    its slice."""
    plan = weight_plan(cfg)
    total = sum(math.prod(shape) for _, shape, _ in plan)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape, scale in plan:
        n = math.prod(shape)
        view = flat[off:off + n].view(shape)
        view.mul_(scale)
        out[name] = view
        off += n
    return out


def _sizes(arch) -> Dict:
    a = arch.attention
    return {"num_layers": arch.num_layers, "d_model": arch.d_model,
            "d_ff": arch.d_ff, "vocab_size": arch.vocab_size,
            "num_heads": a.num_heads, "num_kv_heads": a.num_kv_heads,
            "head_dim": a.head_dim, "rope_theta": float(a.rope_theta),
            "qk_norm": a.qk_norm, "num_patches": arch.num_patches,
            "padded_vocab": arch.padded_vocab()}


def arch_config(cfg: Dict):
    """The port's ``ArchConfig`` for a configuration file: the port's own
    config of ``port_arch`` with the file's sizes, compression and
    numerics.  A file at the port's published sizes has to match them
    size for size (a mismatch raises: the file is what runs); one marked
    ``cut_below_port`` (the CPU tests) replaces them."""
    from repro_torch.configs.registry import get_config
    arch = get_config(cfg["port_arch"])
    bc = cfg["block_circulant"]
    num = cfg["numerics"]
    built = dataclasses.replace(
        arch, num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        num_patches=cfg["frontend"]["num_patches"],
        dtype=num["compute_dtype"], param_dtype=num["param_dtype"],
        attention=dataclasses.replace(
            arch.attention, num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg["num_key_value_heads"],
            head_dim=work.head_dim(cfg), rope_theta=float(cfg["rope_theta"]),
            qk_norm=bool(cfg.get("qk_norm"))),
        compression=dataclasses.replace(
            arch.compression, enabled=True, block_attn=bc["block_attn"],
            block_ffn=bc["block_ffn"], gauss_trick=bc["gauss_trick"],
            fuse_projections=bc["fuse_projections"]))
    want, have = _sizes(built), _sizes(arch)
    if built.padded_vocab() != work.padded_vocab(cfg) or (
            want != have and not cfg.get("cut_below_port")):
        diff = {k: (want[k], have[k]) for k in want if want[k] != have[k]}
        raise ValueError(f"{cfg['_name']}: the file and the port's "
                         f"{cfg['port_arch']} differ (file, port): {diff}; "
                         f"padded vocabulary {work.padded_vocab(cfg)} "
                         f"against {built.padded_vocab()}")
    return built


def build_program_model(arch, weights: Dict[str, torch.Tensor], device):
    """The port's ``Transformer`` on ``device`` holding a copy of
    ``weights``; its parameters must be exactly the plan's."""
    from repro_torch.models.transformer import Transformer
    model = Transformer(arch, device=device)     # zeros: no generator
    load_into(model, weights)
    return model


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    have = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    if have != want:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(n for n in set(have) & set(want)
                        if have[n] != want[n])[:5]
        raise ValueError(f"the program's parameters are not the plan's: "
                         f"missing {missing}, extra {extra}, shapes {shapes}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
