"""Seeded initial weights, drawn on the device, handed alike to the
program and to the reference.

A configuration's reference names every leaf with its shape, stored
dtype and initial distribution (``param_spec``).  The random leaves of
one layer (``blocks.<i>.``), and the others, are drawn in one float32
``randn`` call per group from one ``torch.Generator`` on the device,
then scaled and cast leaf by leaf; the distributions are the program's
own (``LM``'s init), so the first steps see the weights a user's run
sees.  The same seed draws the same weights again, group by group, so a
caller can stream them without holding a second copy.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from pbench.traffic import STREAM_WEIGHTS, torch_seed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _group(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "blocks" else "top"


def groups(spec: list) -> List[Tuple[str, list]]:
    """The spec's leaves in order, cut into runs of one group."""
    out: List[Tuple[str, list]] = []
    for leaf in spec:
        g = _group(leaf[0])
        if not out or out[-1][0] != g:
            out.append((g, []))
        out[-1][1].append(leaf)
    return out


def _fill(init, shape, draw, device) -> torch.Tensor:
    kind = init[0]
    if kind == "normal":
        n = math.prod(shape)
        return draw(n).reshape(shape) * float(init[1])
    if kind == "ones":
        return torch.ones(shape, device=device)
    if kind == "zeros":
        return torch.zeros(shape, device=device)
    if kind == "log_linspace":
        return torch.log(torch.linspace(float(init[1]), float(init[2]),
                                        shape[0], device=device))
    raise ValueError(f"unknown init {init!r}")


def stream(spec: list, seed: int, device) -> Iterator[Dict[str, torch.Tensor]]:
    """One ``{name: tensor in its stored dtype}`` per group, in order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, STREAM_WEIGHTS))
    for _, leaves in groups(spec):
        n = sum(math.prod(s) for _, s, _, init in leaves
                if init[0] == "normal")
        buf = (torch.randn(n, generator=gen, device=device)
               if n else torch.empty(0, device=device))
        offset = [0]

        def draw(k, _buf=buf):
            out = _buf[offset[0]:offset[0] + k]
            offset[0] += k
            return out
        yield {name: _fill(init, tuple(shape), draw, device).to(DTYPES[dt])
               for name, shape, dt, init in leaves}
        del buf


def weights(spec: list, seed: int, device) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for part in stream(spec, seed, device):
        out.update(part)
    return out


def check_like(spec: list, params: Dict[str, torch.Tensor]) -> None:
    """The program's parameters are exactly the spec's leaves: the same
    names, shapes and dtypes."""
    got = {(n, tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in params.items()}
    want = {(n, tuple(s), dt) for n, s, dt, _ in spec}
    if got != want:
        diff = sorted(got ^ want)[:5]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's spec ({len(got)} vs {len(want)} "
                         f"leaves; first differences {diff})")


@torch.no_grad()
def load_into(spec: list, params: Dict[str, torch.Tensor], seed: int) -> None:
    """Write the seeded weights into the program's parameters in place."""
    check_like(spec, params)
    device = next(iter(params.values())).device
    for part in stream(spec, seed, device):
        for name, t in part.items():
            params[name].copy_(t)
