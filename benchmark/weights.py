"""The weights a run hands to the program and to the reference alike: a flat
mapping of ``/``-joined keys to float32 tensors on the device.

``weights`` in a configuration file is either the path of a shipped
``.npz`` (relative to the checkout) or ``"seeded"``: drawn on the device
from the run's seed, in two large calls, with the usual initialisations,
each normal draw truncated at two standard deviations: ViT's for the
backbone (linear kernels and position embeddings N(0, 0.02)), He's for the
conv head (std sqrt(2 / fan-in) before a ReLU, sqrt(1 / fan-in) for the
output conv), biases 0, LayerNorm scales 1.  A head drawn at a fixed std
instead saturates its sigmoids at D 768 on some seeds, and a saturated
score reads the same in every precision.  The size tower's output conv is
the exception: drawn at ``SIZE_GAIN`` times He's std, with its bias at the
logit of 1 / ``search_factor``, so the size map sits where a trained
head's does, at the target's share of the search window, and varies by a
few per cent.  Drawn at He's std, its errors compound through the
size-rate clamp: within some twenty updates every box fills the frame,
the clamp to the frame then gives every cell the same box, and the box
path reads the same in every precision.  The program takes float32
masters and casts them to its compute dtype itself.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping

import numpy as np
import torch

from .counts import hidden

SIZE_GAIN = 0.03


def shapes(fields: Mapping) -> Dict[str, tuple]:
    """Key -> shape of every weight of the configuration."""
    d, p = int(fields["embed_dim"]), int(fields["patch_size"])
    h = hidden(fields)
    nz = (int(fields["template_size"]) // p) ** 2
    nx = (int(fields["search_size"]) // p) ** 2
    out = {"backbone/patch_embed/kernel": (p * p * 3, d),
           "backbone/patch_embed/bias": (d,),
           "backbone/pos_embed_z": (nz, d), "backbone/pos_embed_x": (nx, d),
           "backbone/norm/scale": (d,), "backbone/norm/bias": (d,)}
    for i in range(int(fields["depth"])):
        b = f"backbone/blocks/{i}/"
        for ln in ("ln1", "ln2"):
            out[b + ln + "/scale"] = (d,)
            out[b + ln + "/bias"] = (d,)
        for name, (n_in, n_out) in (("qkv", (d, 3 * d)), ("proj", (d, d)),
                                    ("mlp1", (d, h)), ("mlp2", (h, d))):
            out[b + name + "/kernel"] = (n_in, n_out)
            out[b + name + "/bias"] = (n_out,)
    chans = [d, d // 2, d // 4, d // 8]
    for tower, n_out in (("score", 1), ("offset", 2), ("size", 2)):
        for j in range(3):
            out[f"head/{tower}/{j}/kernel"] = (3, 3, chans[j], chans[j + 1])
            out[f"head/{tower}/{j}/bias"] = (chans[j + 1],)
        out[f"head/{tower}/3/kernel"] = (1, 1, chans[3], n_out)
        out[f"head/{tower}/3/bias"] = (n_out,)
    return out


def _seeded(fields: Mapping, gen: torch.Generator, device
            ) -> Dict[str, torch.Tensor]:
    shp = shapes(fields)

    def he(k):
        kh, kw, c_in, _ = shp[k]
        gain = SIZE_GAIN if k == "head/size/3/kernel" else 1.0
        return gain * ((2.0 if kh > 1 else 1.0) / (kh * kw * c_in)) ** 0.5

    drawn = [[(k, 0.02) for k in shp if k.startswith("backbone/")
              and (k.endswith("/kernel") or "pos_embed" in k)],
             [(k, he(k)) for k in shp if k.startswith("head/")
              and k.endswith("/kernel")]]
    out: Dict[str, torch.Tensor] = {}
    for leaves in drawn:
        sizes = [int(np.prod(shp[k])) for k, _ in leaves]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(flat, a=-2.0, b=2.0, generator=gen)
        for (k, std), part in zip(leaves, torch.split(flat, sizes)):
            out[k] = (std * part).reshape(shp[k])
    for k, s in shp.items():
        if k not in out:
            fill = 1.0 if k.endswith("/scale") else 0.0
            out[k] = torch.full(s, fill, dtype=torch.float32, device=device)
    share = 1.0 / float(fields["search_factor"])
    out["head/size/3/bias"].fill_(math.log(share / (1.0 - share)))
    return out


def make(fields: Mapping, spec: str, root: str, gen: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """The flat weights of a configuration: ``spec`` is its ``weights``."""
    if spec == "seeded":
        return _seeded(fields, gen, device)
    shp = shapes(fields)
    with np.load(os.path.join(root, spec)) as data:
        missing = set(shp) - set(data.files)
        if missing:
            raise KeyError(f"{spec} lacks {sorted(missing)[:3]}")
        out = {k: torch.from_numpy(np.asarray(data[k], np.float32)).to(device)
               for k in shp}
    for k, s in shp.items():
        if tuple(out[k].shape) != s:
            raise ValueError(f"{spec}: {k} is {tuple(out[k].shape)}, not {s}")
    return out


def nest(flat: Mapping[str, torch.Tensor]) -> dict:
    """The nested tree of dicts (lists where the keys count from 0) that
    the flat keys spell."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
