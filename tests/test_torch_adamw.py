"""AdamW's kernels (``kernels/adamw.py``, ``csrc/adamw.cu``).

On the CPU, with the library mocked: a CUDA tensor launches the clip norm
once per update and the update kernel once per parameter, counted in
``LAUNCHES``, and never the plain version; a failed launch raises; a CUDA
case the kernels do not take raises; a DTensor whose shards are on the
CPU takes the plain version, one whose shards are on a card the kernels
on its shards; and over four gloo processes, with the library's C
interface emulated on the host's memory, the sharded clip scale counts
each element once and the update on the shards equals the plain one.

On the card (marker ``chip``; ``python3 -m pytest -q
tests/test_torch_adamw.py -m chip``): the kernels against the plain
version (``AdamW.update_plain``, ``AdamW.clip_scale_plain``) on the same
inputs, in the working dtype: m and v within 2 fp32 ulp, the parameter
within 1 ulp of its dtype, the clip scale within 1e-6 relative (the sum
of squares is taken in another order); DTensors on a one-device mesh
updated through the kernels on their shards bitwise plain tensors
through the kernels; an interrupted update resumed
from its cursor bitwise an uninterrupted one; and ``Trainer.step``
updating every parameter through the kernel with no elementwise PyTorch
kernel and no host synchronisation in the update.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as ka
from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES
from repro_torch.optim.adamw import AdamW, AdamWState, UpdateCursor


# ---------------------------------------------------------------------------
# the routes, on the CPU with the library mocked
# ---------------------------------------------------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so the wrapper
    takes its kernel route on a machine without a GPU."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


class _FakeLib:
    """Stands in for the ctypes library: records calls, returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return self.err
        return launch


@pytest.fixture
def fake_cuda(monkeypatch):
    tables = []

    def table(rows, device):
        tables.append(rows)
        return torch.tensor(rows, dtype=torch.int64).as_subclass(_FakeCuda)

    def install(err):
        lib = _FakeLib(err)
        lib.tables = tables
        monkeypatch.setattr(ka, "library", lambda: lib)
        monkeypatch.setattr(ka, "_stream_handle", lambda device: 0)
        monkeypatch.setattr(ka, "_table", table)
        monkeypatch.setattr(
            ka, "_alloc", lambda shape, dtype, device: torch.full(
                shape, float("nan"), dtype=dtype).as_subclass(_FakeCuda))
        return lib
    return install


# (shape, dtype) of each parameter: bf16 matrices and vector, the fp32
# ssm.D-like leaf, and one gradient of more than one norm chunk
SHAPES = [((4, 8), torch.bfloat16), ((64,), torch.float32),
          ((300,), torch.bfloat16), ((ka.NORM_CHUNK + 5,), torch.bfloat16)]


def _tree(seed=0, shapes=SHAPES, fake=True):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, (shape, dtype) in enumerate(shapes):
        t = torch.randn(shape, generator=g).to(dtype)
        out[f"p{i}"] = t.as_subclass(_FakeCuda) if fake else t
    return out


def _state(params, fake=True):
    def zeros():
        return {n: (torch.zeros(p.shape).as_subclass(_FakeCuda) if fake
                    else torch.zeros(p.shape)) for n, p in params.items()}
    return AdamWState(0, zeros(), zeros())


def _plain(tree):
    return {n: t.as_subclass(torch.Tensor).clone() for n, t in tree.items()}


def _launched(before):
    return {k: LAUNCHES[k] - before[k] for k in ("adamw", "adamw_norm")}


def test_cuda_tensors_launch_the_kernels_not_the_plain_version(fake_cuda):
    lib = fake_cuda(0)
    params, grads = _tree(0), _tree(1)
    state = _state(params)
    was = _plain(params)
    opt = AdamW(lr=1e-3, clip_norm=1.0)
    before = dict(LAUNCHES)
    cur = opt.begin(grads, state)
    new = opt.apply(cur, grads, state, params)
    assert [c[0] for c in lib.calls] == ["adamw_norm"] + ["adamw"] * 4
    assert _launched(before) == {"adamw": 4, "adamw_norm": 1}
    assert cur.done == 4 and new.step == 1
    # the fake launches write nothing: the plain version did not run
    for n, t in _plain(params).items():
        assert torch.equal(t, was[n])
    assert all(not m.any() for m in new.m.values())

    # the norm's table: pointer, length, first chunk, dtype per gradient
    rows = lib.tables[-1]
    assert [r[1] for r in rows] == [32, 64, 300, ka.NORM_CHUNK + 5]
    assert [r[2] for r in rows] == [0, 1, 2, 3]
    assert [r[3] for r in rows] == [1, 0, 1, 1]
    assert [r[0] for r in rows] == [g.data_ptr() for g in grads.values()]
    norm_args = lib.calls[0][1]
    # tensors, chunks (2 for the last), chunk length
    assert norm_args[1:4] == (4, 5, ka.NORM_CHUNK)
    assert norm_args[5:7] == (ka.NORM_MAX_CTAS, 1.0)
    assert norm_args[7] == cur.scale.data_ptr()

    # each update: its tensors, length, dtype, the device scale, scalars
    for (name, args), n in zip(lib.calls[1:], params):
        assert args[:4] == (params[n].data_ptr(), grads[n].data_ptr(),
                            state.m[n].data_ptr(), state.v[n].data_ptr())
        assert args[4] == params[n].numel()
        assert args[5] == (1 if params[n].dtype == torch.bfloat16 else 0)
        assert args[6] == cur.scale.data_ptr()
        assert args[7:] == (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1 / cur.bc1,
                            1 / cur.bc2, 1e-8, 0.01, 1e-3, 0)


def test_begin_launches_a_constant_number_of_kernels(fake_cuda):
    lib = fake_cuda(0)
    opt = AdamW()
    for n_params in (1, 4, 40):
        grads = _tree(n_params, [((8,), torch.bfloat16)] * n_params)
        lib.calls.clear()
        opt.begin(grads, AdamWState(0, {}, {}))
        assert [c[0] for c in lib.calls] == ["adamw_norm"]


def test_no_clip_launches_no_norm_and_passes_no_scale(fake_cuda):
    lib = fake_cuda(0)
    params, grads = _tree(0), _tree(1)
    state = _state(params)
    before = dict(LAUNCHES)
    AdamW(clip_norm=0.0).update(grads, state, params)
    assert [c[0] for c in lib.calls] == ["adamw"] * 4
    assert all(args[6] is None for _, args in lib.calls)
    assert _launched(before) == {"adamw": 4, "adamw_norm": 0}


@pytest.mark.parametrize("where", ["norm", "update"])
def test_failed_launch_raises(fake_cuda, where):
    fake_cuda(1)                                    # cudaErrorInvalidValue
    params, grads = _tree(0), _tree(1)
    state = _state(params)
    opt = AdamW(clip_norm=1.0 if where == "norm" else 0.0)
    before = dict(LAUNCHES)
    if where == "norm":
        with pytest.raises(RuntimeError, match="adamw_norm launch failed"):
            opt.begin(grads, state)
    else:
        cur = opt.begin(grads, state)
        with pytest.raises(RuntimeError, match="adamw launch failed"):
            opt.apply(cur, grads, state, params)
        assert cur.done == 0
    assert LAUNCHES == before


def _bad_case(case):
    p = torch.randn(16, 16).to(torch.bfloat16)
    g, m, v = p.clone(), torch.zeros(16, 16), torch.zeros(16, 16)
    if case == "dtype mix":
        g = g.float()
    elif case == "float16":
        p, g = p.half(), g.half()
    elif case == "non-contiguous":
        p, g = p.t(), g.t()
    elif case == "bf16 moment":
        m = m.to(torch.bfloat16)
    fake = [t.as_subclass(_FakeCuda) for t in (p, g, m, v)]
    if case == "device mismatch":
        fake[2] = m                                 # m on the CPU
    return fake


@pytest.mark.parametrize("case", ["dtype mix", "float16", "non-contiguous",
                                  "bf16 moment", "device mismatch"])
def test_a_cuda_case_the_kernel_does_not_take_raises(fake_cuda, case):
    lib = fake_cuda(0)
    p, g, m, v = _bad_case(case)
    opt = AdamW(clip_norm=0.0)
    cur = opt.begin({"w": g}, AdamWState(0, {"w": m}, {"w": v}))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError):
        opt.apply(cur, {"w": g}, AdamWState(0, {"w": m}, {"w": v}),
                  {"w": p})
    assert lib.calls == [] and LAUNCHES == before and cur.done == 0


@pytest.mark.parametrize("case", ["float16", "non-contiguous"])
def test_the_clip_norm_refuses_what_it_does_not_take(fake_cuda, case):
    lib = fake_cuda(0)
    _, g, _, _ = _bad_case(case)
    ok = torch.ones(4, dtype=torch.bfloat16).as_subclass(_FakeCuda)
    with pytest.raises(ValueError):
        AdamW().begin({"a": ok, "b": g}, AdamWState(0, {}, {}))
    assert lib.calls == []


def _dtensors(mesh, *trees):
    from torch.distributed.tensor import DTensor, Replicate
    return [{n: DTensor.from_local(t, mesh, [Replicate()])
             for n, t in tree.items()} for tree in trees]


def test_dtensors_take_the_plain_version(fake_cuda):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import ensure_process_group

    lib = fake_cuda(0)
    own = ensure_process_group("cpu")
    try:
        mesh = init_device_mesh("cpu", (1,))
        params, grads = _tree(0, fake=False), _tree(1, fake=False)
        zeros = {n: torch.zeros(p.shape) for n, p in params.items()}
        d_params, d_grads, d_m, d_v = _dtensors(
            mesh, params, grads, zeros,
            {n: z.clone() for n, z in zeros.items()})
        d_state = AdamWState(0, d_m, d_v)
        state = _state(params, fake=False)
        before = dict(LAUNCHES)
        d_state = AdamW().update(d_grads, d_state, d_params)
        AdamW().update(grads, state, params)
        assert lib.calls == [] and LAUNCHES == before
        for n in params:
            assert torch.equal(d_params[n].to_local(), params[n])
            assert torch.equal(d_state.m[n].to_local(), state.m[n])
        # the shards decide: on the CPU the plain version
        assert build.route_all(d_params.values(), "AdamW") == "plain"
    finally:
        if own:
            dist.destroy_process_group()


def test_dtensors_on_a_card_launch_the_kernels_on_their_shards(
        fake_cuda, monkeypatch):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import ensure_process_group

    lib = fake_cuda(0)
    # the shards stay CPU tensors: the scale and sums are allocated there
    monkeypatch.setattr(ka, "_alloc", lambda shape, dtype, device: torch.full(
        shape, float("nan"), dtype=dtype))
    own = ensure_process_group("cpu")
    try:
        mesh = init_device_mesh("cpu", (1,))
        params, grads = _tree(0, fake=False), _tree(1, fake=False)
        zeros = {n: torch.zeros(p.shape) for n, p in params.items()}
        d_params, d_grads, d_m, d_v = _dtensors(
            mesh, params, grads, zeros,
            {n: z.clone() for n, z in zeros.items()})
        monkeypatch.setattr(DTensor, "device", property(
            lambda self: torch.device("cuda", 0)))
        assert build.route_all(d_params.values(), "AdamW") == "shards"
        opt = AdamW(lr=1e-3, clip_norm=1.0)
        before = dict(LAUNCHES)
        cur = opt.begin(d_grads, AdamWState(0, d_m, d_v))
        opt.apply(cur, d_grads, AdamWState(0, d_m, d_v), d_params)
        assert [c[0] for c in lib.calls] == (
            ["adamw_norm_sum", "adamw_norm_scale"] + ["adamw"] * 4)
        assert _launched(before) == {"adamw": 4, "adamw_norm": 1}
        # the sum over every shard (a one-rank mesh counts them all)
        assert [r[0] for r in lib.tables[-1]] == [
            g.to_local().data_ptr() for g in d_grads.values()]
        total = lib.calls[0][1][6]
        assert lib.calls[1][1][:3] == (total, 1.0, cur.scale.data_ptr())
        assert not isinstance(cur.scale, DTensor)
        for (_, args), n in zip(lib.calls[2:], params):
            assert args[:4] == tuple(t[n].to_local().data_ptr() for t in (
                d_params, d_grads, d_m, d_v))
            assert args[6] == cur.scale.data_ptr()
    finally:
        if own:
            dist.destroy_process_group()


@pytest.mark.parametrize("case", ["a mix", "placements", "partial"])
def test_the_shard_route_refuses_what_does_not_line_up(fake_cuda,
                                                       monkeypatch, case):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.launch.mesh import ensure_process_group

    lib = fake_cuda(0)
    own = ensure_process_group("cpu")
    try:
        mesh = init_device_mesh("cpu", (1,))
        p, g, m, v = (torch.randn(8, 4) for _ in range(4))
        d = _dtensors(mesh, {"w": p}, {"w": g}, {"w": m}, {"w": v})
        d_p, d_g, d_m, d_v = (t["w"] for t in d)
        monkeypatch.setattr(DTensor, "device", property(
            lambda self: torch.device("cuda", 0)))
        opt = AdamW(clip_norm=1.0 if case == "partial" else 0.0)
        with pytest.raises(ValueError):
            if case == "a mix":
                build.route_all([d_p, g.as_subclass(_FakeCuda)], "AdamW")
            elif case == "placements":
                d_m = DTensor.from_local(m, mesh, [Shard(0)])
                cur = opt.begin({"w": d_g}, AdamWState(0, {}, {}))
                opt.apply(cur, {"w": d_g}, AdamWState(0, {"w": d_m},
                                                      {"w": d_v}),
                          {"w": d_p})
            else:
                d_g = DTensor.from_local(g, mesh, [Partial()])
                opt.begin({"w": d_g}, AdamWState(0, {}, {}))
        assert lib.calls == []
    finally:
        if own:
            dist.destroy_process_group()


# four gloo ranks on a (2, 2) mesh, the library's C interface emulated on
# the host's memory (pointers read through ctypes), so the shard route's
# bookkeeping (which rank counts which shard, the sums over the mesh, the
# in-place writes through the shards) runs as on cards
_FOUR = """
import ctypes, json, math, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels import adamw as ka, build
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import sharded_update
from repro_torch.optim.adamw import AdamW, AdamWState

def view(ptr, n, ctype):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))

class Emulated:
    def adamw_norm_sum(self, table, n_rows, n_chunks, chunk, partial,
                       max_ctas, total, stream):
        rows = view(table, 4 * max(n_rows, 1), ctypes.c_int64)
        view(total, 1, ctypes.c_double)[0] = sum(
            float(np.square(view(int(ptr), int(n), ctypes.c_float)
                            .astype(np.float64)).sum())
            for ptr, n, _, _ in rows.reshape(-1, 4)[:n_rows])
        return 0

    def adamw_norm_scale(self, total, clip, scale, stream):
        t = view(total, 1, ctypes.c_double)[0]
        view(scale, 1, ctypes.c_float)[0] = min(1.0, clip / (math.sqrt(t)
                                                             + 1e-9))
        return 0

    def adamw(self, p, g, m, v, n, dtype, scale, b1, a1, b2, a2, rbc1, rbc2,
              eps, wd, lr, stream):
        P, G, M, V = (view(x, n, ctypes.c_float) for x in (p, g, m, v))
        gs = G * (view(scale, 1, ctypes.c_float)[0] if scale else 1.0)
        M[:] = b1 * M + a1 * gs
        V[:] = b2 * V + a2 * gs * gs
        P[:] = P - lr * ((M * rbc1) / (np.sqrt(V * rbc2) + eps) + wd * P)
        return 0

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], rank=rank,
                        world_size=4)
mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
g = torch.Generator().manual_seed(0)
# each parameter's placements, and its moments' (ZeRO-1: the data axis)
layout = {"rep": ([Replicate(), Replicate()], [Shard(0), Replicate()]),
          "cols": ([Replicate(), Shard(1)], [Shard(0), Shard(1)]),
          "rows": ([Shard(0), Replicate()], [Shard(0), Replicate()]),
          "both": ([Shard(0), Shard(1)], [Shard(0), Shard(1)])}
full = {n: (torch.randn(8, 6, generator=g), torch.randn(8, 6, generator=g))
        for n in layout}

def run(route):
    params = {n: distribute_tensor(p.clone(), mesh, layout[n][0])
              for n, (p, _) in full.items()}
    grads = {n: distribute_tensor(gr.clone(), mesh, layout[n][0])
             for n, (_, gr) in full.items()}
    zeros = lambda: {n: distribute_tensor(torch.zeros(8, 6), mesh,
                                          layout[n][1]) for n in layout}
    state = AdamWState(0, zeros(), zeros())
    opt = AdamW(lr=1e-2, clip_norm=0.25)
    for _ in range(2):
        cur = opt.begin(grads, state)
        state = sharded_update(opt, grads, state, params,
                               {n: layout[n][1] for n in layout})
    scale = cur.scale
    scale = float(scale.full_tensor() if hasattr(scale, "full_tensor")
                  else scale)
    return scale, {n: (params[n].full_tensor(), state.m[n].full_tensor())
                   for n in layout}

plain_scale, plain = run("plain")
ka.library = lambda: Emulated()
ka._stream_handle = lambda device: 0
ka._table = lambda rows, device: torch.tensor(rows, dtype=torch.int64)
real = build.route_all
build.route_all = lambda ts, what: ("shards" if real(ts, what) == "plain"
                                    else real(ts, what))
shard_scale, shard = run("shards")
gap = max(float(((shard[n][i] - plain[n][i]).abs()
                 / plain[n][i].abs().clamp_min(1e-6)).max())
          for n in layout for i in (0, 1))
moved = min(float((plain[n][0] - full[n][0]).abs().max()) for n in layout)
if rank == 0:
    json.dump({"plain_scale": plain_scale, "shard_scale": shard_scale,
               "gap": gap, "moved": moved}, open(sys.argv[3], "w"))
dist.destroy_process_group()
"""

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_route_counts_each_element_once_over_a_mesh(tmp_path):
    """The shard route on a (2, 2) gloo mesh (the C interface emulated),
    two ZeRO-1 updates over replicated, row-, column- and fully sharded
    parameters: the clip scale the plain version's over the full
    gradients (a replicated shard counted twice would lower it), the
    parameters and moments the plain version's."""
    out = tmp_path / "four.json"
    url = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _FOUR, str(r), url,
                               str(out)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    deadline, errs = time.monotonic() + 120, []
    for p in procs:
        try:
            _, err = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    import json
    got = json.loads(out.read_text())
    assert got["plain_scale"] < 0.5                 # the clip is active
    assert abs(got["shard_scale"] / got["plain_scale"] - 1) <= 1e-6
    assert got["gap"] <= 1e-4 and got["moved"] > 1e-3


def test_cpu_tensors_take_the_plain_version(fake_cuda):
    lib = fake_cuda(0)
    params, grads = _tree(0, fake=False), _tree(1, fake=False)
    state = _state(params, fake=False)
    was = _plain(params)
    AdamW(lr=0.1).update(grads, state, params)
    assert lib.calls == []
    assert all(not torch.equal(params[n], was[n]) for n in params)


# ---------------------------------------------------------------------------
# on the card: the kernels against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    return torch.device("cuda")


def _ulps(got: torch.Tensor, want: torch.Tensor, mant_bits: int) -> float:
    """The largest gap between ``got`` and ``want`` in units of the last
    place of ``want`` in a format of ``mant_bits`` significand bits."""
    got, want = got.double(), want.double()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), (e - mant_bits).to(torch.int32))
    ulp = torch.where(want == 0, torch.full_like(want, 2.0 ** -149), ulp)
    return float(((got - want).abs() / ulp).max())


# element counts of the parameters, and how each is laid out: the
# stablelm embedding, a norm, an odd length, views whose offset breaks
# 16-byte alignment (the parameter and gradient only, and all four
# tensors alike), the fp32 ssm.D-like leaf
CARD_CASES = [(shape, layout, dtype)
              for shape, layout in [((50304, 2560), "dense"),
                                    ((2560,), "dense"),
                                    ((1_000_003,), "dense"),
                                    ((1_000_003,), "offset param"),
                                    ((1_000_003,), "offset all")]
              for dtype in ("bfloat16", "float32")] + [
    ((64,), "dense", "float32")]


def _card_inputs(shape, layout, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    n = int(np.prod(shape))

    def draw(dt, scale, off):
        base = torch.randn(n + off, generator=g, device=device) * scale
        return base.to(dt)[off:].view(shape)
    off_pg = 1 if layout != "dense" else 0
    off_mv = 1 if layout == "offset all" else 0
    p = draw(dtype, 0.02, off_pg)
    grad = draw(dtype, 1e-2, off_pg)
    m = draw(torch.float32, 1e-3, off_mv)
    v = draw(torch.float32, 1e-5, off_mv).abs()
    return p, grad, m, v


def _cursor(opt, step, scale):
    return UpdateCursor(step, scale, 3e-4, 1 - opt.b1 ** step,
                        1 - opt.b2 ** step)


@pytest.mark.chip
@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("shape,layout,dtype", CARD_CASES)
def test_update_kernel_matches_plain_on_card(card, shape, layout, dtype,
                                             clip, step):
    dtype = getattr(torch, dtype)
    # the same draws twice: the same values at the same offsets
    p, g, m, v = _card_inputs(shape, layout, dtype, card)
    kp, _, km, kv = _card_inputs(shape, layout, dtype, card)
    assert kp.storage_offset() == p.storage_offset()
    # a clip at half the gradient's norm: the scale is about 0.5
    opt = AdamW(clip_norm=0.5 * float(g.float().norm()) if clip else 0.0)
    scale = ka.clip_scale([g], opt.clip_norm) if clip else None
    if clip:
        assert 0 < float(scale) < 1
    cur = _cursor(opt, step, scale)
    before = dict(LAUNCHES)
    ka.update(kp, g, km, kv, scale, lr=cur.lr, b1=opt.b1, b2=opt.b2,
              eps=opt.eps, weight_decay=opt.weight_decay, bc1=cur.bc1,
              bc2=cur.bc2)
    opt.update_plain(cur, p, g, m, v)
    torch.cuda.synchronize()
    assert _launched(before)["adamw"] == 1
    assert _ulps(km, m, 24) <= 2 and _ulps(kv, v, 24) <= 2
    assert _ulps(kp, p, 8 if dtype == torch.bfloat16 else 24) <= 1


@pytest.mark.chip
@pytest.mark.parametrize("clip", [0.5, 1e9])
def test_clip_scale_matches_plain_on_card(card, clip):
    gen = torch.Generator(device=card).manual_seed(1)
    grads = [(torch.randn(s, generator=gen, device=card) * 1e-2).to(dt)
             for s, dt in [((50304, 2560), torch.bfloat16),
                           ((2560,), torch.bfloat16),
                           ((1_000_003,), torch.bfloat16),
                           ((64,), torch.float32), ((0,), torch.float32),
                           ((4096, 4096), torch.float32)]]
    opt = AdamW(clip_norm=clip)
    before = dict(LAUNCHES)
    got = ka.clip_scale(grads, clip)
    again = ka.clip_scale(grads, clip)
    want = opt.clip_scale_plain(grads)
    assert _launched(before)["adamw_norm"] == 2
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, again)                  # no atomics: same bits
    if clip > 1e6:
        assert float(got) == 1.0 == float(want)
    else:
        assert abs(float(got) / float(want) - 1) <= 1e-6


@pytest.mark.chip
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_shard_route_on_a_one_device_mesh_is_bitwise_on_card(card, clip):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import ensure_process_group

    shapes = [(2560, 64), (64,), (1_000_003,), (333, 7)]
    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float32]

    def setup():
        torch.manual_seed(5)
        params = {f"w{i}": torch.randn(s, device=card).to(dt)
                  for i, (s, dt) in enumerate(zip(shapes, dtypes))}
        grads = {n: torch.randn_like(p) * 1e-2 for n, p in params.items()}
        return params, grads, AdamW().init(params)

    opt = AdamW(lr=1e-3, clip_norm=clip)
    params, grads, state = setup()
    for _ in range(2):
        want_scale = opt.begin(grads, state).scale
        state = opt.update(grads, state, params)

    own = ensure_process_group("cuda")
    try:
        mesh = init_device_mesh("cuda", (1,))

        def dt(tree):
            return {n: distribute_tensor(t, mesh, [Replicate()])
                    for n, t in tree.items()}
        d_params, d_grads, d_state = setup()
        d_params, d_grads = dt(d_params), dt(d_grads)
        d_state = AdamWState(0, dt(d_state.m), dt(d_state.v))
        before = dict(LAUNCHES)
        for _ in range(2):
            scale = opt.begin(d_grads, d_state).scale
            d_state = opt.update(d_grads, d_state, d_params)
        torch.cuda.synchronize()
        assert _launched(before) == {"adamw": 2 * len(shapes),
                                     "adamw_norm": 4 if clip else 0}
        if clip:
            assert torch.equal(scale, want_scale)
        for n in params:
            assert torch.equal(d_params[n].to_local(), params[n])
            assert torch.equal(d_state.m[n].to_local(), state.m[n])
            assert torch.equal(d_state.v[n].to_local(), state.v[n])
    finally:
        if own:
            dist.destroy_process_group()


@pytest.mark.chip
@pytest.mark.parametrize("k", [0, 2, 4])
def test_interrupted_update_resumes_bitwise_on_card(card, k):
    shapes = [(2560, 64), (64,), (1_000_003,), (2560,), (333, 7)]
    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16,
              torch.bfloat16, torch.float32]

    def setup():
        torch.manual_seed(3)
        params = {f"w{i}": torch.randn(s, device=card).to(dt)
                  for i, (s, dt) in enumerate(zip(shapes, dtypes))}
        grads = {n: torch.randn_like(p) for n, p in params.items()}
        return params, grads, AdamW().init(params)

    opt = AdamW(lr=1e-3)
    params, grads, state = setup()
    opt.update(grads, state, params)

    r_params, r_grads, r_state = setup()
    cur = opt.begin(r_grads, r_state)
    calls = {"n": 0}

    def moments(name):
        calls["n"] += 1
        if calls["n"] == k + 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return r_state.m[name], r_state.v[name]
    with pytest.raises(torch.OutOfMemoryError):
        opt.apply(cur, r_grads, r_state, r_params, moments)
    assert cur.done == k
    opt.apply(cur, r_grads, r_state, r_params, moments)
    assert cur.done == len(shapes)
    for n in params:
        assert torch.equal(r_params[n], params[n])
        assert torch.equal(r_state.m[n], state.m[n])
        assert torch.equal(r_state.v[n], state.v[n])


@pytest.mark.chip
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_trainer_updates_every_parameter_through_the_kernel(card, dtype):
    from repro_torch.core.planner import NonePlanner
    from repro_torch.data.pipeline import make_batches
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import Trainer

    cfg = get_config("bert_base_paper").reduced(
        num_layers=2, d_model=128, d_ff=256, vocab_size=512, dtype=dtype)
    lm = LM(cfg, device="cuda")
    trainer = Trainer(lm, NonePlanner(lm), AdamW(lr=1e-3))
    steps = 3
    before = dict(LAUNCHES)
    trainer.run(make_batches("swag", batch_size=4, vocab_size=512,
                             num_batches=steps, quantum=32, seed=0))
    assert _launched(before) == {"adamw": len(trainer.params) * steps,
                                 "adamw_norm": steps}

    # one more update alone: only the kernels (and the norm's table copy)
    # on the device, and no host synchronisation
    grads = {n: torch.randn_like(p) for n, p in trainer.params.items()}
    opt, state = trainer.optimizer, trainer.optimizer.init(trainer.params)
    opt.begin(grads, state)                         # pinned memory cached
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.apply(opt.begin(grads, state), grads, state, trainer.params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if "Memcpy" not in n]
    assert kernels and all("adamw" in n for n in kernels), sorted(set(names))
    assert sum("adamw_kernel" in n for n in kernels) == len(trainer.params)
    assert sum("adamw_norm" in n for n in kernels) == 2
