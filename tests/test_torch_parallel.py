"""fft_conv_tpu_torch.parallel on 8 gloo ranks against fft_conv_tpu.parallel; torch compiles no HLO to read, so the collectives are counted from torch.profiler's c10d events."""

import json
import multiprocessing
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from fft_conv_tpu import fft_conv, fft_conv_transpose
from fft_conv_tpu import parallel as jax_parallel
from fft_conv_tpu.parallel.shard import _tp_plan as jax_tp_plan
from fft_conv_tpu_torch.parallel import make_mesh
from fft_conv_tpu_torch.parallel.shard import _tp_plan

from helpers import _assert_almost_equal, _assert_close_scaled

JOIN_TIMEOUT_S = 300
# the JAX lines that hold a fused or tiled local path use the scaled bar
SCALED = {"impl-fused", "impl-tiled", "fused2d", "transpose-fused", "fused-grad"}


def _jax_calls(name):
    """(the JAX line's unsharded reference, the same call through
    fft_conv_tpu.parallel on a mesh of the case's shape), each a function
    of (signal, kernel, bias)."""
    shape, fn, _, _, kwargs, opts = ranks.CASES[name]
    mesh = jax_parallel.make_mesh(*shape)
    kwargs = dict(kwargs)
    impl = kwargs.pop("impl", None)
    tp_mode = kwargs.pop("tp_mode", "out")
    ref_kw = dict(kwargs, impl="xla") if impl else kwargs
    if fn == "transpose":
        def ref(s, w, b):
            return fft_conv_transpose(s, w, b, **ref_kw)
    else:
        def ref(s, w, b):
            return fft_conv(s, w, b, **ref_kw)
    if "placed" in opts and fn == "sharded":
        def sharded(s, w, b):
            return fft_conv(*jax_parallel.shard_conv_inputs(s, w, b, mesh), **kwargs)
    elif "placed" in opts:
        specs = jax_parallel.transpose_input_specs(mesh)

        def sharded(s, w, b):
            s, w, b = (jax.device_put(a, p) for a, p in zip((s, w, b), specs))
            return fft_conv_transpose(s, w, b, **kwargs)
    else:
        call = {"spatial": jax_parallel.fft_conv_spatial_sharded,
                "sharded": jax_parallel.fft_conv_sharded,
                "transpose": jax_parallel.fft_conv_transpose_sharded}[fn]
        # JAX's fused kernels run in interpret mode here, 6-8 s a call;
        # test_torch_fused{1,2}d.py hold the port's kernels against them, so
        # the fused lines' sharded reference is JAX's composed local path
        extra = {"impl": "xla" if impl == "fused" else impl} if impl else {}
        if fn == "sharded":
            extra["tp_mode"] = tp_mode

        def sharded(s, w, b):
            return call(s, w, b, mesh=mesh, **kwargs, **extra)
    return ref, sharded


def _jax_references():
    """Per case, {"ref": ..., "sharded": ...}: the output, or for a gradient
    case the gradients of .sum() with respect to (signal, kernel, bias)."""
    out = {}
    for name, (_, _, _, _, _, opts) in ranks.CASES.items():
        if "raises" in opts:
            continue
        args = [None if a is None else jnp.asarray(a) for a in ranks.inputs(name)]
        out[name] = {}
        for which, fn in zip(("ref", "sharded"), _jax_calls(name)):
            if "grad" in opts:
                g = jax.grad(lambda *a: fn(*a).sum(), argnums=(0, 1, 2))(*args)
                out[name][which] = dict(zip(("signal", "kernel", "bias"), map(np.asarray, g)))
            else:
                out[name][which] = np.asarray(fn(*args))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawns the 8 gloo ranks once for the module (spawn: this process has
    imported JAX), computes the JAX references while they run, and returns
    (per rank (arrays, record), references)."""
    out_dir = tmp_path_factory.mktemp("ranks")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.run_rank, args=(r, str(out_dir)))
             for r in range(ranks.WORLD)]
    for p in procs:
        p.start()
    try:
        refs = _jax_references()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        # stop at the first rank that fails: the others would wait for it
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = [(out_dir / f"rank{r}.err") for r in range(ranks.WORLD)]
    errors = [e.read_text() for e in errors if e.exists()]
    assert not errors, errors[0]
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    per_rank = []
    for r in range(ranks.WORLD):
        with np.load(out_dir / f"rank{r}.npz") as f:
            arrays = dict(f)
        per_rank.append((arrays, json.loads((out_dir / f"rank{r}.json").read_text())))
    return per_rank, refs


def _ranks_of(run, name):
    """The (arrays, record) of every rank that ran ``name``: all of its
    mesh, and only it."""
    per_rank, _ = run
    mesh_size = int(np.prod(ranks.CASES[name][0]))
    ran = [r for r, (_, rec) in enumerate(per_rank) if name in rec]
    assert ran == list(range(mesh_size)), (name, ran)
    return [per_rank[r] for r in ran]


def _check(run, name):
    """Every rank's output (or gradients) against the JAX line's reference
    and JAX's sharded call, at the JAX line's tolerance."""
    assert_close = _assert_close_scaled if name in SCALED else _assert_almost_equal
    refs = run[1][name]
    for arrays, _ in _ranks_of(run, name):
        for which in ("ref", "sharded"):
            if "grad" in ranks.CASES[name][5]:
                for what, g in refs[which].items():
                    assert_close(arrays[f"{name}:grad_{what}"], g)
            else:
                assert_close(arrays[f"{name}:y"], refs[which])


def _collectives(run, name):
    return [rec[name]["collectives"] for _, rec in _ranks_of(run, name)]


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1),
    (2, 3, 2, 1),
    (1, 4, 1, 3),
    (3, 1, 1, 2),
])
def test_overlap_save_matches_single_device_1d(run, stride, padding, dilation, groups):
    _check(run, f"os1d-{stride}-{padding}-{dilation}-{groups}")


def test_overlap_save_matches_single_device_2d(run):
    _check(run, "os2d")


def test_overlap_save_non_divisible_length_auto_pads(run):
    _check(run, "os-nondivisible")


def test_overlap_save_halo_too_large_raises(run):
    for _, rec in _ranks_of(run, "os-halo"):
        assert rec["os-halo"]["raised"] and "halo" in rec["os-halo"]["raised"]
    with pytest.raises(ValueError):
        jax_parallel.fft_conv_spatial_sharded(
            jnp.ones((1, 1, 64)), jnp.ones((1, 1, 33)), mesh=jax_parallel.make_mesh(spatial=8))


def test_overlap_save_gradients_match(run):
    _check(run, "os-grad")


def test_dp_tp_sharded_forward_exact(run):
    """Placed inputs: bitwise equal to the port's unsharded call, within the
    bar of JAX's, and the output placed (data, model)."""
    _check(run, "placed-exact")
    for arrays, rec in _ranks_of(run, "placed-exact"):
        assert np.array_equal(arrays["placed-exact:y"], arrays["placed-exact:unsharded"])
        assert rec["placed-exact"]["placements"] == [
            "Shard(dim=0)", "Shard(dim=1)", "Replicate()"]
        assert rec["placed-exact"]["collectives"]["total"] == 0


def test_dp_shard_map_forward_collective_free(run):
    """The batch-DP forward makes no collective and no c10d call at all."""
    _check(run, "dp")
    assert all(c == {"total": 0} for c in _collectives(run, "dp"))


@pytest.mark.parametrize("groups,tp_mode", [(1, "out"), (2, "out"), (1, "in")])
def test_dp_tp_shard_map_matches(run, groups, tp_mode):
    """Out-channel and whole-group TP forwards make no collective; the
    in-channel one makes exactly one all-reduce, and nothing else."""
    name = f"dptp-{groups}-{tp_mode}"
    _check(run, name)
    for counts in _collectives(run, name):
        if tp_mode == "in":
            assert {k: v for k, v in counts.items() if k != "total"} == {"all_reduce": 1}
        else:
            assert counts == {"total": 0}


@pytest.mark.parametrize("groups", [1, 2])
def test_transpose_shard_map_matches(run, groups):
    _check(run, f"transpose-{groups}")
    assert all(c == {"total": 0} for c in _collectives(run, f"transpose-{groups}"))


@pytest.mark.parametrize("impl", ["fused", "tiled"])
def test_dp_tp_shard_map_fused_impl_matches(run, impl):
    """The fused kernel's plain version and the tiled path as each rank's
    local implementation."""
    _check(run, f"impl-{impl}")


def test_dp_tp_shard_map_fused2d_matches(run):
    _check(run, "fused2d")


def test_transpose_shard_map_fused_impl_matches(run):
    _check(run, "transpose-fused")


def test_sharded_fused_gradients_match(run):
    """Gradients through the fused route under DP+TP: the replicated
    kernel's and bias's partial gradients summed over the data dimension,
    the signal's over the model dimension."""
    _check(run, "fused-grad")


def test_sharded_gradients_match(run):
    _check(run, "grad")


def test_overlap_save_uses_only_ppermute(run):
    """The halo exchange is point to point: one send and one receive per
    rank, the gather of the blocks, and no reduction or all-to-all."""
    _check(run, "os-p2p")
    for counts in _collectives(run, "os-p2p"):
        assert counts["send"] == 1 and counts["recv"] == 1
        for kind in ("all_reduce", "all_to_all", "alltoall", "reduce_scatter"):
            assert kind not in counts, counts


def test_tp_transpose_sharded_forward(run):
    """Inputs placed with transpose_input_specs (torch's distribute_tensor,
    no broadcast) into the transposed function; the output is placed (data,
    model)."""
    _check(run, "transpose-placed")
    for _, rec in _ranks_of(run, "transpose-placed"):
        assert rec["transpose-placed"]["placements"] == [
            "Shard(dim=0)", "Shard(dim=1)", "Replicate()"]


def test_profiler_counts_a_deliberate_all_reduce(run):
    """The positive control of the counts above: an empty count is not a
    profiler that records nothing."""
    per_rank, _ = run
    for _, rec in per_rank:
        assert rec["control-all_reduce"]["all_reduce"] == 1


def test_checks_that_need_a_group_raise(run):
    """A batch that does not split over the data dimension, a mesh larger
    than the group, and a rank outside the mesh raise ValueError."""
    per_rank, _ = run
    for r, (_, rec) in enumerate(per_rank):
        assert "not divisible by data axis" in rec["batch-not-divisible"]
        assert "mesh needs 16 ranks" in rec["mesh-too-large"]
        if r >= 4:
            assert rec["outside-the-mesh"] == "this rank is not part of the mesh"


@pytest.mark.parametrize("groups,cin,cout,model_size,tp_mode", [
    (1, 6, 8, 2, "sideways"),   # unknown mode
    (2, 6, 8, 2, "in"),         # in-channel mode with groups
    (1, 5, 8, 2, "in"),         # in-channels do not split
    (1, 6, 7, 2, "out"),        # out-channels do not split
    (3, 6, 6, 2, "out"),        # groups do not split
])
def test_tp_plan_raises_as_jax_does(groups, cin, cout, model_size, tp_mode):
    with pytest.raises(ValueError) as port:
        _tp_plan(groups, cin, cout, model_size, tp_mode)
    with pytest.raises(ValueError) as ref:
        jax_tp_plan(groups, cin, cout, model_size, tp_mode)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("groups,cin,cout,model_size,tp_mode", [
    (1, 6, 8, 1, "out"), (4, 8, 8, 1, "out"), (1, 6, 8, 2, "out"),
    (4, 8, 8, 2, "out"), (1, 6, 8, 2, "in"),
])
def test_tp_plan_matches_jax(groups, cin, cout, model_size, tp_mode):
    assert _tp_plan(groups, cin, cout, model_size, tp_mode) == jax_tp_plan(
        groups, cin, cout, model_size, tp_mode)


def test_make_mesh_wants_the_card_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_import_pulls_in_no_jax():
    code = (
        "import sys, fft_conv_tpu_torch.parallel; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fft_conv_tpu' or m.startswith('fft_conv_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
