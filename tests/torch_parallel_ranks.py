"""The rank body of ``tests/test_torch_parallel.py``: one process of an
8-rank gloo group on the CPU, running every case of ``tests/test_sharding.py``
through ``fft_conv_tpu_torch.parallel``.

It imports torch, numpy and the port only (the test process has imported
JAX; the ranks are spawned fresh). Each rank writes its outputs, gradients
and output placements to ``rank<r>.npz`` / ``rank<r>.json`` in the run's
directory, with the collective calls ``torch.profiler`` recorded in each
case's forward, and its traceback to ``rank<r>.err`` if it fails.
"""

import datetime
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8

# name -> (mesh (data, model, spatial), function, seed (None: ones), shapes
# (signal, kernel, bias or None), keyword arguments, options); the seeds,
# shapes and arguments of each test of tests/test_sharding.py. Options:
# "grad" (the gradients of .sum()), "placed" (inputs placed first by
# shard_conv_inputs or transpose_input_specs), "raises" (ValueError expected)
_OS1D = [(1, 0, 1, 1), (2, 3, 2, 1), (1, 4, 1, 3), (3, 1, 1, 2)]
_DPTP = [(1, "out"), (2, "out"), (1, "in")]
CASES = {
    **{
        f"os1d-{t}-{p}-{d}-{g}": (
            (1, 1, 8), "spatial", 0, [(2, 6, 512), (6, 6 // g, 17), (6,)],
            dict(stride=t, padding=p, dilation=d, groups=g), ())
        for t, p, d, g in _OS1D
    },
    "os2d": ((1, 1, 8), "spatial", 1, [(2, 3, 24, 64), (4, 3, 5, 5), (4,)],
             dict(padding=2), ()),
    "os-nondivisible": ((1, 1, 8), "spatial", 2, [(1, 2, 509), (3, 2, 9), None], {}, ()),
    "os-halo": ((1, 1, 8), "spatial", None, [(1, 1, 64), (1, 1, 33), None], {}, ("raises",)),
    "os-grad": ((1, 1, 8), "spatial", 3, [(2, 3, 256), (4, 3, 17), (4,)], {}, ("grad",)),
    "os-p2p": ((1, 1, 8), "spatial", None, [(1, 2, 512), (3, 2, 9), None], {}, ()),
    "placed-exact": ((4, 2, 1), "sharded", 4, [(8, 6, 256), (8, 6, 33), (8,)],
                     dict(padding=16), ("placed",)),
    "dp": ((8, 1, 1), "sharded", None, [(8, 4, 128), (4, 4, 9), (4,)], {}, ()),
    **{
        f"dptp-{g}-{m}": ((4, 2, 1), "sharded", 6, [(8, 6, 256), (8, 6 // g, 33), (8,)],
                          dict(padding=16, groups=g, tp_mode=m), ())
        for g, m in _DPTP
    },
    **{
        f"transpose-{g}": ((4, 2, 1), "transpose", 7, [(8, 6, 64), (6, 8 // g, 9), (8,)],
                           dict(stride=2, groups=g), ())
        for g in (1, 2)
    },
    **{
        f"impl-{impl}": ((4, 2, 1), "sharded", 9, [(8, 6, 256), (8, 6, 33), (8,)],
                         dict(padding=16, impl=impl), ())
        for impl in ("fused", "tiled")
    },
    "fused2d": ((2, 2, 1), "sharded", 10, [(4, 4, 96, 160), (4, 4, 5, 5), (4,)],
                dict(padding=2, impl="fused"), ()),
    "transpose-fused": ((2, 2, 1), "transpose", 11, [(4, 6, 128), (6, 8, 9), (8,)],
                        dict(impl="fused"), ()),
    "fused-grad": ((4, 2, 1), "sharded", 12, [(8, 6, 256), (8, 6, 33), (8,)],
                   dict(impl="fused"), ("grad",)),
    "grad": ((4, 2, 1), "sharded", 8, [(8, 6, 256), (8, 6, 33), (8,)], {}, ("grad",)),
    "transpose-placed": ((2, 2, 1), "transpose", 5, [(4, 6, 64), (6, 8, 9), (8,)],
                         dict(stride=2), ("placed",)),
}


def inputs(name):
    """The case's (signal, kernel, bias) as float32 numpy arrays, drawn as
    the JAX test draws them (one generator, in that order)."""
    _, _, seed, shapes, _, _ = CASES[name]
    rng = None if seed is None else np.random.default_rng(seed)
    out = []
    for shape in shapes:
        if shape is None:
            out.append(None)
        elif rng is None:
            out.append(np.ones(shape, np.float32))
        else:
            out.append(rng.standard_normal(shape).astype(np.float32))
    return out


def collectives(prof):
    """Counts of the collective and point-to-point calls in a profile, by
    the backend's name for them ("gloo:all_reduce", "gloo:send", ...), and
    the count of every event of the c10d layers (``total``)."""
    counts = {"total": 0}
    for evt in prof.events():
        if evt.name.startswith(("gloo:", "nccl:", "c10d::", "_c10d_functional::")):
            counts["total"] += 1
            if evt.name.startswith(("gloo:", "nccl:")):
                kind = evt.name.split(":", 1)[1]
                counts[kind] = counts.get(kind, 0) + 1
    return counts


def _run_case(name, meshes, arrays, record):
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.profiler import ProfilerActivity, profile

    from fft_conv_tpu_torch import fft_conv
    from fft_conv_tpu_torch.parallel import (
        fft_conv_sharded,
        fft_conv_spatial_sharded,
        fft_conv_transpose_sharded,
        shard_conv_inputs,
        transpose_input_specs,
    )

    shape, fn, _, _, kwargs, opts = CASES[name]
    mesh = meshes[shape]
    if mesh.get_coordinate() is None:
        return  # this rank is outside the case's mesh
    sig, w, b = (None if a is None else torch.from_numpy(a) for a in inputs(name))
    if "grad" in opts:
        for t in (sig, w, b):
            t.requires_grad_()
    call = {"spatial": fft_conv_spatial_sharded, "sharded": fft_conv_sharded,
            "transpose": fft_conv_transpose_sharded}[fn]
    if "raises" in opts:
        try:
            call(sig, w, b, mesh=mesh, **kwargs)
        except ValueError as e:
            record[name] = {"raised": str(e)}
            return
        record[name] = {"raised": None}
        return

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if "placed" in opts and fn == "sharded":
            y = fft_conv_sharded(*shard_conv_inputs(sig, w, b, mesh), mesh=mesh, **kwargs)
        elif "placed" in opts:
            sig_p, ker_p, bias_p = transpose_input_specs(mesh)
            y = fft_conv_transpose_sharded(
                distribute_tensor(sig, mesh, sig_p, src_data_rank=None),
                distribute_tensor(w, mesh, ker_p, src_data_rank=None),
                distribute_tensor(b, mesh, bias_p, src_data_rank=None),
                mesh=mesh, **kwargs)
        else:
            y = call(sig, w, b, mesh=mesh, **kwargs)
    rec = {"collectives": collectives(prof)}
    if isinstance(y, DTensor):
        rec["placements"] = [repr(p) for p in y.placements]
        y = y.full_tensor()
    arrays[f"{name}:y"] = y.detach().numpy()
    if name == "placed-exact":  # the same call unsharded, for the bitwise check
        arrays[f"{name}:unsharded"] = fft_conv(sig, w, b, **kwargs).numpy()
    if "grad" in opts:
        y.sum().backward()
        for what, t in (("signal", sig), ("kernel", w), ("bias", b)):
            arrays[f"{name}:grad_{what}"] = t.grad.numpy()
    record[name] = rec


def _checks(meshes, record):
    """The ValueError cases that need a group, the rank outside a mesh, and
    the profiler's positive control: a deliberate all_reduce is counted."""
    from torch.profiler import ProfilerActivity, profile

    from fft_conv_tpu_torch.parallel import fft_conv_sharded, make_mesh

    def raised(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    sig, w = torch.ones(6, 4, 64), torch.ones(4, 4, 9)
    record["batch-not-divisible"] = raised(
        lambda: fft_conv_sharded(sig, w, mesh=meshes[(4, 2, 1)]))
    record["mesh-too-large"] = raised(lambda: make_mesh(data=16, device_type="cpu"))
    if meshes[(2, 2, 1)].get_coordinate() is None:
        record["outside-the-mesh"] = raised(
            lambda: fft_conv_sharded(torch.ones(4, 4, 64), w, mesh=meshes[(2, 2, 1)]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dist.all_reduce(torch.ones(3))
    record["control-all_reduce"] = collectives(prof)


def run_rank(rank, out_dir):
    """Joins the group as ``rank``, builds the meshes (every rank takes part
    in each, as ``make_mesh`` requires), runs every case and writes the
    results."""
    torch.set_num_threads(1)
    try:
        from fft_conv_tpu_torch.parallel import make_mesh

        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD),
            rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
        meshes = {}
        for shape, *_ in CASES.values():
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape, device_type="cpu")
        arrays, record = {}, {}
        for name in CASES:
            _run_case(name, meshes, arrays, record)
        _checks(meshes, record)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
