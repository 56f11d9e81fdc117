"""The port's ``launch`` package (mesh, placement rules, input stand-ins,
dry run, roofline) against the JAX package's ``repro.launch``, on the CPU.

JAX's rules read only a mesh's ``shape`` and ``axis_names``, so its side
takes a stand-in mesh (no 256 devices), and its ``NamedSharding`` is
replaced by the bare ``PartitionSpec`` for the length of a test
(monkeypatch; the JAX package is not edited).  The port's side takes a
stand-in with ``mesh_dim_names`` and ``shape``, or a ``fake`` process
group of 256 / 512 ranks (the dry run's own), torn down after each test.
Placements are compared entry by entry after one normalisation:
``PartitionSpec`` stores a one-axis tuple as the axis name and an empty
tuple as None.  Everything here is exact: placements, shapes, dtypes and
byte counts are integers.
"""
import functools
import math
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import repro.configs as jconfigs
import repro.launch.input_specs as jinput
import repro.launch.mesh as jmesh
import repro.launch.roofline as jroofline
import repro.launch.sharding as jsharding
import repro.models as jmodels
import repro_torch.configs as tconfigs
import repro_torch.launch.input_specs as tinput
import repro_torch.launch.roofline as troofline
import repro_torch.launch.sharding as tsharding
import repro_torch.models as tmodels
from repro.training.optim import AdamW as JAdamW
from repro_torch.launch import dryrun, mesh as tmesh

ARCHS = jconfigs.ARCH_IDS
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _jax_mesh(tag):
    shape = MESHES[tag]
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _torch_mesh(tag):
    shape = MESHES[tag]
    return types.SimpleNamespace(mesh_dim_names=tuple(shape),
                                 shape=tuple(shape.values()))


@pytest.fixture
def bare_specs(monkeypatch):
    """JAX's sharding functions return bare PartitionSpecs."""
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)


@pytest.fixture(autouse=True)
def no_process_group_left():
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a test left a process group initialised")


def _norm_entry(e):
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _norm(spec):
    return tuple(_norm_entry(e) for e in spec)


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PS))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _torch_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _same_specs(got_tree, want_tree):
    got, want = _torch_leaves(got_tree), _jax_leaves(want_tree)
    assert got.keys() == want.keys()
    for key, spec in want.items():
        assert _norm(got[key]) == _norm(tuple(spec)), key


@pytest.fixture(scope="module")
def abstract():
    """{arch: (JAX's abstract params, the port's meta params)}."""
    return {a: (jmodels.abstract_params(jconfigs.get_config(a)),
                tmodels.abstract_params(tconfigs.get_config(a)))
            for a in ARCHS}


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_jax(arch, tag, abstract, bare_specs):
    """Every parameter of the full configuration, under the policy
    ``zero_policy`` picks and under ZeRO-3 (the optimizer state's)."""
    jp, tp = abstract[arch]
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for policy in (None, "zero3", "zero1"):
        _same_specs(
            tsharding.params_shardings(tp, _torch_mesh(tag), tc, policy),
            jsharding.params_shardings(jp, _jax_mesh(tag), jc, policy))
    for path, leaf in _torch_leaves(tp).items():
        assert _norm(tsharding.param_spec(path, tuple(leaf.shape),
                                          _torch_mesh(tag), tc)) == \
            _norm(tuple(jsharding.param_spec(path, tuple(leaf.shape),
                                             _jax_mesh(tag), jc)))


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_policy_matches_jax(arch):
    assert tsharding.zero_policy(tconfigs.get_config(arch)) == \
        jsharding.zero_policy(jconfigs.get_config(arch))
    assert tsharding.zero_policy(None) == jsharding.zero_policy(None)


ACT_FIELDS = ("hidden", "heads", "kv", "ffn", "expert", "logits")


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_act_sharding_matches_jax(arch, tag):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jm, tm = _jax_mesh(tag), _torch_mesh(tag)
    for batch, seq in ((256, 4096), (32, None), (128, 32768), (1, None),
                       (48, 4096)):
        want = jsharding.act_sharding(jc, jm, batch, seq=seq)
        got = tsharding.act_sharding(tc, tm, batch, seq=seq)
        for f in ACT_FIELDS:
            w = getattr(want, f)
            assert (getattr(got, f) is None) == (w is None), f
            if w is not None:
                assert _norm(getattr(got, f)) == _norm(tuple(w)), f
        assert (got.moe_mesh is tm) == (want.moe_mesh is jm)
        assert tuple(got.moe_dp_axes) == tuple(want.moe_dp_axes)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_match_jax(arch, tag, bare_specs):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for batch in (256, 32, 1):
        for kind in ("train", "prefill", "decode"):
            want = jsharding.batch_shardings(jc, _jax_mesh(tag), batch, kind)
            got = tsharding.batch_shardings(tc, _torch_mesh(tag), batch, kind)
            assert got.keys() == want.keys()
            for k in want:
                assert _norm(got[k]) == _norm(tuple(want[k])), (kind, k)


def _cells():
    for arch in ARCHS:
        for name, shape in tmodels.SHAPES.items():
            yield arch, name


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_jax(arch, tag, bare_specs):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        jshape, tshape = jmodels.SHAPES[name], tmodels.SHAPES[name]
        if not tinput.cell_is_applicable(tc, tshape)[0]:
            continue
        jcache = jinput.cache_specs(jc, jshape)
        tcache = tinput.cache_specs(tc, tshape)
        for for_decode in (True, False):
            _same_specs(
                tsharding.cache_shardings(tcache, tc, _torch_mesh(tag),
                                          tshape.global_batch, for_decode),
                jsharding.cache_shardings(jcache, jc, _jax_mesh(tag),
                                          jshape.global_batch, for_decode))


@pytest.mark.parametrize("arch,shape", list(_cells()))
def test_input_specs_match_jax(arch, shape):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    js, ts = jmodels.SHAPES[shape], tmodels.SHAPES[shape]
    ok = tinput.cell_is_applicable(tc, ts)
    assert ok == jinput.cell_is_applicable(jc, js)
    if not ok[0]:
        return
    want = _jax_leaves(jinput.input_specs(jc, js))
    got = _torch_leaves(tinput.input_specs(tc, ts))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].device.type == "meta", key
        assert tuple(got[key].shape) == tuple(w.shape), key
        assert str(got[key].dtype).replace("torch.", "") == str(w.dtype), key


# ---------------------------------------------------------------------------
# the dry run: per-device argument bytes against JAX's PartitionSpecs
# ---------------------------------------------------------------------------

def _jax_local_bytes(tree, specs, mesh_shape):
    """Bytes of one device's blocks: each leaf's size over the product of
    the axis sizes its PartitionSpec shards it by."""
    total = 0
    leaves, specs = _jax_leaves(tree), _jax_leaves(specs)
    assert leaves.keys() == specs.keys()
    for key, leaf in leaves.items():
        div = 1
        for e in tuple(specs[key]):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                div *= mesh_shape[a]
        n = math.prod(leaf.shape)
        assert n % div == 0, key
        total += n // div * np.dtype(leaf.dtype).itemsize
    return total


def _jax_argument_bytes(arch, shape_name, tag):
    cfg, shape = jconfigs.get_config(arch), jmodels.SHAPES[shape_name]
    mesh = _jax_mesh(tag)
    ap = jmodels.abstract_params(cfg)
    total = _jax_local_bytes(ap, jsharding.params_shardings(ap, mesh, cfg),
                             mesh.shape)
    if shape.kind == "train":
        aopt = jax.eval_shape(JAdamW().init, ap)
        z3 = jsharding.params_shardings(ap, mesh, cfg, policy="zero3")
        total += _jax_local_bytes(aopt.m, z3, mesh.shape) + \
            _jax_local_bytes(aopt.v, z3, mesh.shape) + 4
    if shape.kind in ("train", "prefill"):
        b = jinput.batch_specs(cfg, shape, shape.kind == "train")
        total += _jax_local_bytes(b, jsharding.batch_shardings(
            cfg, mesh, shape.global_batch, shape.kind), mesh.shape)
    else:
        c = jinput.cache_specs(cfg, shape)
        total += _jax_local_bytes(c, jsharding.cache_shardings(
            c, cfg, mesh, shape.global_batch), mesh.shape)
        total += shape.global_batch * 4                # the token, whole
    return total


@functools.lru_cache(maxsize=None)
def _lower_cell(arch, shape, multi_pod):
    """``dryrun.lower_cell``, once a cell in this module (the train cell
    walks 36 layers, 4 microbatches, in about 17 s)."""
    return dryrun.lower_cell(arch, shape, multi_pod)


DRYRUN_CELLS = [("qwen2.5-3b", "train_4k", "16x16"),
                ("qwen2.5-3b", "prefill_32k", "2x16x16"),
                ("qwen3-moe-235b-a22b", "decode_32k", "16x16"),
                ("qwen3-moe-235b-a22b", "decode_32k", "2x16x16"),
                ("recurrentgemma-9b", "decode_32k", "16x16"),
                ("xlstm-1.3b", "long_500k", "2x16x16")]


@pytest.mark.parametrize("arch,shape,tag", DRYRUN_CELLS)
def test_dryrun_argument_bytes_match_jax_partition_specs(arch, shape, tag,
                                                         bare_specs):
    """One dense, one MoE and two recurrent cells, on a fake process group
    of 256 or 512 ranks: the report's per-device argument bytes equal the
    shard sizes reckoned from JAX's PartitionSpecs (a decode cache's
    recurrent states split over ``model`` too), and every field the
    roofline reads is there."""
    rep = _lower_cell(arch, shape, tag == "2x16x16")
    assert rep["status"] == "ok" and rep["chips"] == math.prod(
        MESHES[tag].values())
    pd = rep["per_device"]
    assert pd["argument_bytes"] == _jax_argument_bytes(arch, shape, tag)
    assert pd["flops"] > 0 and pd["bytes_accessed"] > 0
    assert pd["temp_bytes"] is None
    coll = pd["collective_bytes"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    row = troofline.roofline_row(rep)
    assert row["mesh"] == tag and row["dominant"] in ("compute", "memory",
                                                      "collective")


def test_dryrun_flops_count_the_step():
    """qwen2.5-3b decode on a 16x16 mesh: the matmul FLOPs of rank 0's
    tensor-parallel decode step, reckoned by hand: its 128 / 16 rows, its
    16 / 16 query heads, both KV heads (2 do not divide 16: ``wk``/``wv``
    whole), F / 16 of the gated MLP, every head's scores and output over
    its 128 / 16 slice of head_dim of the 32k cache, V / 16 of the
    logits."""
    cfg, shape = tconfigs.get_config("qwen2.5-3b"), tmodels.SHAPES[
        "decode_32k"]
    rep = dryrun.lower_cell("qwen2.5-3b", "decode_32k", False)
    m = 16
    b, s, d = shape.global_batch // 16, shape.seq_len, cfg.d_model
    per_layer = 2 * b * d * (cfg.q_dim // m + 2 * cfg.kv_dim) \
        + 2 * b * cfg.q_dim // m * d \
        + 2 * b * d * cfg.d_ff // m * 3 \
        + 2 * 2 * b * cfg.num_heads * s * cfg.head_dim // m
    want = cfg.num_layers * per_layer + 2 * b * d * cfg.vocab_size // m
    assert rep["per_device"]["flops"] == pytest.approx(want, rel=1e-9)
    # the collectives the program ran: per layer the row-parallel sums of
    # wo and w_down, (b, 1, D) float32 each, and the scores' sum, (b, H,
    # 1, S) float32; the embedding's sum; two exchanges of the query and
    # output, (b, 1, H, Dh) / 16 bf16 each
    coll = rep["per_device"]["collective_bytes"]
    assert coll["all-reduce"] == cfg.num_layers * (
        2 * b * d * 4 + b * cfg.num_heads * s * 4) + b * d * 4
    assert coll["all-to-all"] == cfg.num_layers * 2 * (
        b * cfg.num_heads * cfg.head_dim // m * 2)


def test_dryrun_train_counts_the_rank_program():
    """qwen2.5-3b train_4k on a 16x16 mesh: rank 0's tensor-parallel train
    step, reckoned by hand.  Its dp block of the batch is 256 / 16 = 16
    rows, 4 microbatches of 4 x 4,096 tokens (T).  A layer's forward
    matmuls at its local widths: q over its 1 of 16 heads, k and v whole (2
    KV heads do not divide 16), the 4,096 x 4,096 scores and their output
    for its head, ``wo``'s rows and F / 16 of the gated MLP; the head over
    V / 16.  The backward doubles each; ``remat`` recomputes each layer but
    ``w_down``'s product (the recompute stops once every tensor the
    backward saved is back).  The all-reduces: per layer the float32 (T,
    D) sums of ``wo`` and ``w_down`` in the forward and of ``wo`` in the
    recompute, and the bf16 (T, D) ``sum_gradients`` of the attention's
    and the MLP's inputs in the backward; the embedding's float32 sum and
    the head input's bf16 one; the loss's row maxima (T float32) and its
    sums beside the label logits (2 T float32).  No whole logits: the
    logits block is V / 16 columns."""
    cfg = tconfigs.get_config("qwen2.5-3b")
    shape = tmodels.SHAPES["train_4k"]
    rep = _lower_cell("qwen2.5-3b", "train_4k", False)
    m, mb = 16, dryrun.microbatches_for("qwen2.5-3b")
    b, s, d = shape.global_batch // 16 // mb, shape.seq_len, cfg.d_model
    t = b * s
    down = 2 * t * cfg.d_ff // m * d
    layer = 2 * t * d * (cfg.q_dim // m + 2 * cfg.kv_dim) \
        + 2 * 2 * b * (cfg.num_heads // m) * s * s * cfg.head_dim \
        + 2 * t * cfg.q_dim // m * d + 2 * down + down
    head = 2 * t * d * cfg.vocab_size // m
    want = mb * (cfg.num_layers * (4 * layer - down) + 3 * head)
    pd = rep["per_device"]
    assert pd["flops"] == want
    all_reduce = mb * (cfg.num_layers * (3 * t * d * 4 + 2 * t * d * 2)
                       + t * d * 4 + t * d * 2 + t * 4 + 2 * t * 4)
    assert pd["collective_bytes"]["all-reduce"] == all_reduce
    assert pd["activations"]["logits"] == t * cfg.vocab_size // m * 4
    assert pd["activations"]["heads"] == t * cfg.head_dim * 2


def test_dryrun_recurrent_decode_is_the_rank_program():
    """xlstm-1.3b long_500k on the 2x16x16 mesh (B 1, whole on every rank;
    ZeRO-1 of a model whose 4 heads do not divide 16 stores every weight
    whole): rank 0's decode step computes its mixers' channel blocks, the
    weights narrowed to D / 16 columns (``w_i``/``w_f`` whole: 4 heads do
    not split 16 ways), the mLSTM's memory at its 512 / 16 key rows.  Its
    matmul FLOPs and its collectives, reckoned by hand: per mLSTM layer
    the q and k ``all_to_all``s (16 blocks of one padded group of Dk bf16),
    the v and output gathers (B, D) bf16 and the float32 all-reduce of the
    (B, H, Dh + 1) partial sums; per sLSTM layer the row-parallel
    ``w_out``'s all-reduce; the embedding's all-reduce and the logits'
    vocabulary gather."""
    cfg = tconfigs.get_config("xlstm-1.3b")
    rep = dryrun.lower_cell("xlstm-1.3b", "long_500k", True)
    b, d, m, h, v = 1, cfg.d_model, 16, cfg.num_heads, cfg.vocab_size
    dh = d // h
    dk = dh // m
    kinds = cfg.layer_kinds()
    nm, ns = kinds.count("mlstm"), kinds.count("slstm")
    mlstm = 4 * 2 * b * d * d // m + 2 * 2 * b * d * h + 2 * b * h * dk * dh
    slstm = 5 * 2 * b * d * d // m
    assert rep["per_device"]["flops"] == nm * mlstm + ns * slstm \
        + 2 * b * d * v // m
    coll = rep["per_device"]["collective_bytes"]
    assert coll["all-to-all"] == nm * 2 * m * b * dk * 2
    assert coll["all-gather"] == nm * 2 * b * d * 2 + b * v * 4
    assert coll["all-reduce"] == b * d * 4 + nm * b * h * (dh + 1) * 4 \
        + ns * b * d * 4
    assert coll["reduce-scatter"] == 0


@pytest.mark.parametrize("arch,seq_par", [("qwen2.5-3b", False),
                                          ("gemma-2b", True)])
def test_dryrun_prefill_is_the_rank_program(arch, seq_par):
    """A prefill cell's FLOPs are rank 0's program: qwen2.5-3b (16 heads)
    splits heads and FFN over the 16 ``model`` ranks, gemma-2b (8 heads)
    runs sequence-parallel (its hidden states' block is S / 16 rows, and
    its K/V gathers are reckoned); either way each rank's FLOPs are far
    below the single program's (a whole-model rank would do 16 times its
    share)."""
    cfg, shape = tconfigs.get_config(arch), tmodels.SHAPES["prefill_32k"]
    rep = dryrun.lower_cell(arch, "prefill_32k", False)
    pd = rep["per_device"]
    b = shape.global_batch // 16
    hidden = pd["activations"]["hidden"]
    rows = shape.seq_len // 16 if seq_par else shape.seq_len
    assert hidden == b * rows * cfg.d_model * 2
    # the MLP's matmuls alone over the rank's rows of the whole sequence,
    # were it whole, exceed the count
    whole_mlp = 2 * b * shape.seq_len * cfg.d_model * cfg.d_ff * 3 \
        * cfg.num_layers
    assert pd["flops"] < whole_mlp
    coll = pd["collective_bytes"]
    assert coll["all-reduce"] > 0 and coll["total"] == sum(
        v for k, v in coll.items() if k != "total")
    if seq_par:         # K and V of every layer gathered over the sequence
        kv = 2 * b * shape.seq_len * cfg.kv_dim * 2 * cfg.num_layers
        assert coll["all-gather"] >= kv


def test_dryrun_main_writes_reports_roofline_reads(tmp_path, capsys):
    dryrun.main(["--arch", "gemma-2b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                 "--both-meshes", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[skipped] gemma-2b__long_500k__pod1" in out
    assert "[     ok] gemma-2b__decode_32k__pod2" in out
    rows = troofline.load_rows(str(tmp_path))
    assert len(rows) == 3 and sum("skipped" in r for r in rows) == 1
    troofline.main(["--dir", str(tmp_path), "--markdown"])
    assert "| gemma-2b | decode_32k | 2x16x16 |" in capsys.readouterr().out


def test_roofline_row_follows_its_formula():
    rep = {"arch": "a", "shape": "train_4k", "multi_pod": True, "chips": 512,
           "params": 10, "active_params": 7, "tokens": 1000,
           "per_device": {"argument_bytes": 3 * 2**30, "temp_bytes": None,
                          "flops": 2e12, "bytes_accessed": 4e9,
                          "collective_bytes": {"total": 1e9}}}
    row = troofline.roofline_row(rep)
    assert row["compute_s"] == 2e12 / 989.4e12
    assert row["memory_s"] == 4e9 / 3.35e12
    assert row["collective_s"] == 1e9 / 50e9
    assert row["dominant"] == "collective"
    assert row["model_flops"] == 6 * 7 * 1000
    assert row["useful_ratio"] == 6 * 7 * 1000 / (2e12 * 512)
    assert row["roofline_frac"] == 6 * 7 * 1000 / 512 / (1e9 / 50e9) \
        / 989.4e12
    assert row["hbm_gib_per_dev"] == 3.0
    assert row["mesh"] == "2x16x16"
    assert set(row) == set(jroofline.roofline_row(dict(
        rep, per_device=dict(rep["per_device"], temp_bytes=0))))
    rep["shape"], rep["per_device"]["temp_bytes"] = "decode_32k", 2**30
    row = troofline.roofline_row(rep)
    assert row["model_flops"] == 2 * 7 * 1000 and row["hbm_gib_per_dev"] == 4


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------

def test_production_meshes_on_a_fake_group():
    import torch.distributed as dist

    for multi_pod, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16),
                                     ("pod", "data", "model"))):
        with dryrun.fake_world(math.prod(shape)):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod,
                                              device="cpu")
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == names
            assert tmesh.dp_axes(mesh) == jmesh.dp_axes(
                types.SimpleNamespace(axis_names=names))
            assert tmesh.axis_sizes(mesh) == dict(zip(names, shape))
            with pytest.raises(RuntimeError, match="needs"):
                tmesh.make_production_mesh(multi_pod=not multi_pod,
                                           device="cpu")
            with pytest.raises(RuntimeError, match="needs"):
                tmesh.make_host_mesh(device="cpu")
        assert not dist.is_initialized()
    with dryrun.fake_world(1):
        mesh = tmesh.make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1) and tmesh.dp_axes(mesh) == \
            ("data",)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(device="cpu")


def test_meshes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_host_mesh()


def test_placements_as_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _torch_mesh("2x16x16")
    assert tsharding.placements(((("pod", "data")), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert tsharding.placements((None, ("data",), None), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert tsharding.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tsharding.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        tsharding.placements(("model", "model"), mesh)
    assert tsharding.local_shape((64, 48), (("pod", "data"), "model"),
                                 mesh) == (2, 3)
    with pytest.raises(ValueError, match="divide"):
        tsharding.local_shape((48, 48), (("pod", "data"), None), mesh)
