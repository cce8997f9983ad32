"""The 'model' axis of use_tpu_torch on int8 serving (parallel/sharding.py,
the cut forward of models/ncsnpp/layers.py's FusedQConv3x3 and QConv)
against use_tpu's parallel/sharding.py, on the CPU.

- The rule: params_shardings names, through convert_jax's naming, exactly
  the leaves use_tpu's rule shards on the NCSN++ in fp32, bf16, 'int8',
  'int8_pallas' and the DDPM net with the residual pyramids (whose FIR
  convs use_tpu names Conv2d_0_weight: kept whole), tiny at a small
  min_size and ncsnpplarge at the rule's default (the port on the meta
  device, use_tpu through jax.eval_shape).
- The forwards: four gloo ranks at (data=2, model=2)
  (tests/helpers/torch_tp_worker.py, kind ``serving``) run the tiny 'int8'
  and 'int8_pallas' nets cut at MIN_SIZE on their data index's lanes,
  against use_tpu's apply over shard_params'd params on the 8-device CPU
  mesh at (2, 2), K3 through its lax oracle (qconv3x3_reference, as
  tests/test_torch_qconv.py runs use_tpu's net; use_tpu's
  test_tensor_parallel_step_matches_data_parallel holds that the cut leaves
  its arithmetic alone): within MODEL_REL_L2, the U-Net tolerance of
  tests/test_torch_int8conv.py and test_torch_qconv.py (a last-bit
  difference of a GroupNorm statistic can flip one quantum, which spreads).
  Every quantized conv call's gathered output is bit-equal (atol 0) to the
  same conv of the uncut port net on the same arguments, and so is the
  cut forward to the uncut one (each cut layer takes its rank's slice of
  the bias inside its conv or kernel, and on the CPU a conv of part of the
  output channels sums each channel as the whole conv does). A 2-step pc
  sample of the cut int8 score model is the uncut one's, bit for bit.
- The preparation of a rank's slice of the weight (K3's and the s8
  conv's) is the matching slice of the whole weight's preparation, bit
  for bit: both quantize per output channel.
- The QConv gate: a conv whose slice (16 output channels) falls under
  min_channels 24 while its whole width (32) does not quantizes, as
  use_tpu's sharded QConv does (it sees the global shape): the cut output
  is the uncut conv's, bit for bit, and use_tpu's within its op tolerance
  (tests/test_torch_int8conv.py: rtol 1e-5, atol 1e-5).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import use_tpu.models  # noqa: F401 (registries)
import use_tpu_torch.models  # noqa: F401 (registries)
from tests.helpers.torch_parity import assert_close, nchw_to_nhwc, random_params
from tests.test_torch_sharding import _launch_ranks, _port_name
from use_tpu.models.ncsnpp.ncsnpp import NCSNpp as JNCSNpp, NCSNppConfig as JConfig
from use_tpu.ops import pallas_qconv as jq
from use_tpu.ops.qconv import QConv as JQConv
from use_tpu.parallel import mesh as jmesh
from use_tpu.parallel import sharding as jsharding
from use_tpu_torch.engine.convert_jax import ncsnpp_params_to_state_dict
from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp as TNCSNpp, NCSNppConfig as TConfig
from use_tpu_torch.ops import fused_qconv as tfq, qconv as tqc
from use_tpu_torch.parallel import mesh as tmesh
from use_tpu_torch.parallel import sharding as tsharding

TINY = dict(nf=16, ch_mult=(1, 2), quant_min_channels=16)
MIN_SIZE = 1 << 8  # every 3x3 conv and every dense layer of TINY is cut
MODEL_REL_L2 = 0.05  # tests/test_torch_int8conv.py, test_torch_qconv.py
OP_RTOL, OP_ATOL = 1e-5, 1e-5
X_SHAPE = (4, 32, 64, 4)  # two lanes a data rank
GATE = (32, 32, 24)  # (C, O, min_channels): O / 2 = 16 < 24 <= 32
SCORE_MODEL = dict(backbone="ncsnpp", condition="noisy", sde_input="noisy", n_fft=62,
                   hop_length=16, num_frames=16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs six test processes at once: two torch threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the rule ---------------------------------------------------------------

def _jax_sharded(params, model, min_size):
    """{port name: size} of the leaves use_tpu's rule shards."""
    mesh = jmesh.make_mesh(model=model, devices=jax.devices()[:8])
    specs = jax.tree_util.tree_leaves(jsharding.params_shardings(params, mesh, min_size))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {_port_name(path, leaf.ndim): int(np.prod(leaf.shape))
            for (path, leaf), s in zip(leaves, specs) if s.spec != P()}


RULE_CASES = {  # name: (config, x shape for use_tpu's init, min_size, leaves cut)
    "fp32": (TINY, X_SHAPE, MIN_SIZE, 42),
    "bf16": (dict(TINY, dtype="bfloat16"), X_SHAPE, MIN_SIZE, 42),
    "int8": (dict(TINY, quant="int8"), X_SHAPE, MIN_SIZE, 42),
    "int8_pallas": (dict(TINY, quant="int8_pallas"), X_SHAPE, MIN_SIZE, 42),
    "ddpm": (dict(TINY, resblock_type="ddpm", progressive="residual",
                  progressive_input="residual", quant="int8"), X_SHAPE, MIN_SIZE, 29),
    "large_int8": (dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2,
                        quant="int8"), (1, 256, 64, 4), 1 << 16, 173),
    "large_int8_pallas": (dict(nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2,
                               quant="int8_pallas"), (1, 256, 64, 4), 1 << 16, 173),
}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_rule_matches_jax_on_the_serving_nets(name):
    """Exactly use_tpu's leaves, on the output axis; the int8 convs among
    them, and the FIR convs of the residual pyramids kept whole."""
    cfg, shape, min_size, count = RULE_CASES[name]
    jnet = JNCSNpp(JConfig(**cfg))
    params = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32),
                            jnp.full((shape[0],), 0.5))["params"]
    want = _jax_sharded(params, 2, min_size)
    with torch.device("meta"):
        net = TNCSNpp(TConfig(**cfg))
    plan = tsharding.params_shardings(net, tmesh.make_mesh(model=2, world=8), min_size)
    sizes = {k: p.numel() for k, p in net.named_parameters()}
    got = {k: sizes[k] for k, axis in plan.items() if axis is not None}
    assert got == want
    assert len(got) == count
    assert all(axis in (None, 0) for axis in plan.values())
    quantized = {"int8": "QConv", "int8_pallas": "FusedQConv3x3"}.get(cfg.get("quant"))
    if quantized:  # every quantized conv of the net is cut
        assert {k for k in got if type(net.get_submodule(k.rpartition(".")[0])).__name__
                == quantized} == {f"{n}.weight" for n, m in net.named_modules()
                                  if type(m).__name__ == quantized}
    if name == "ddpm":
        firs = [k for k in plan if ".Conv2d_0." in k]
        assert firs and all(plan[k] is None for k in firs)


# -- the prepared slice -----------------------------------------------------

@pytest.mark.parametrize("kernel", ["k3", "s8"])
@pytest.mark.parametrize("o,model", [(128, 2), (256, 4), (256, 2)])
def test_prepared_slice_is_the_slice_of_the_whole_preparation(kernel, o, model):
    """Each model rank's slice of an OIHW weight, prepared alone, gives the
    whole weight's preparation at its output channels, bit for bit (K3:
    qw [ceil(C/32), 2, 9, O, 16], sw [O], iu; the s8 conv: qw, sw and the
    kernel's blocks of 128 output channels, a slice of 64 zero past its
    channels)."""
    c, n = 80, o // model
    rng = np.random.default_rng(o + model)
    w = torch.from_numpy((rng.standard_normal((o, c, 3, 3)) / 3).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0.01, 0.1, c).astype(np.float32))

    def channels(qk):  # the s8 blocks [no, nk, 2, 9, 128, 16] by output channel
        return qk.permute(0, 4, 1, 2, 3, 5).reshape(-1, *qk.shape[1:4], qk.shape[5])

    for r in range(model):
        part = slice(r * n, (r + 1) * n)
        if kernel == "k3":
            whole, got = tfq.prepare_qconv_weight(w, u), tfq.prepare_qconv_weight(w[part], u)
            assert torch.equal(got.qw, whole.qw[:, :, :, part])
            assert torch.equal(got.iu, whole.iu)
        else:
            whole, got = tqc.prepare_s8_weight(w, u), tqc.prepare_s8_weight(w[part], u)
            assert torch.equal(got.qw, whole.qw[part])
            assert torch.equal(channels(got.qk)[:n], channels(whole.qk)[part])
            assert not channels(got.qk)[n:].any()
        assert torch.equal(got.sw, whole.sw[part])


# -- four gloo ranks --------------------------------------------------------

def _serving_setup(quant, seed):
    cfg = dict(TINY, quant=quant)
    shapes = jax.eval_shape(JNCSNpp(JConfig(**TINY)).init, jax.random.PRNGKey(0),
                            jnp.zeros(X_SHAPE, jnp.float32), jnp.full((X_SHAPE[0],), 0.5))
    return cfg, random_params(shapes["params"], seed=seed)


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    t = np.array([0.3, 0.8, 0.5, 0.1], np.float32)
    return x, t


def _gate_setup():
    c, o, _ = GATE
    rng = np.random.default_rng(9)
    kernel = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(o)).astype(np.float32)
    x = rng.standard_normal((2, 8, 6, c)).astype(np.float32)  # NHWC
    return kernel, bias, x


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The four port ranks on every case (started first, so that they run
    while use_tpu compiles), then use_tpu's sharded applies."""
    x, t = _inputs()
    wav = (0.3 * np.random.default_rng(11).standard_normal((2, 15 * 16))).astype(np.float32)
    cases, params = [], {}
    for i, quant in enumerate(("int8", "int8_pallas")):
        cfg, params[quant] = _serving_setup(quant, seed=20 + i)
        state = ncsnpp_params_to_state_dict(params[quant])
        common = dict(kind="serving", min_size=MIN_SIZE, params=params[quant], state=state,
                      x=x, t=t)
        cases.append(dict(common, name=quant, config=cfg,
                          score_model=dict(SCORE_MODEL, backbone_kwargs=cfg), wav=wav,
                          seed=3))
        cases.append(dict(common, name=f"{quant}_bf16", config=dict(cfg, dtype="bfloat16")))
    kernel, bias, gx = _gate_setup()
    cases.append(dict(kind="gate", name="gate", conv=GATE, x=np.ascontiguousarray(
        gx.transpose(0, 3, 1, 2)), state={"weight": torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))), "bias": torch.from_numpy(bias)}))
    procs = _launch_ranks(tmp_path_factory.mktemp("tp_serving"), {"cases": cases})
    try:
        mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
        want = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jq, "qconv3x3_fused", jq.qconv3x3_reference)
            for quant, p in params.items():
                jnet = JNCSNpp(JConfig(**dict(TINY, quant=quant)))
                apply = jax.jit(lambda p, x, t, jnet=jnet: jnet.apply({"params": p}, x, t))
                want[quant] = np.asarray(apply(jsharding.shard_params(p, mesh, MIN_SIZE),
                                               jnp.asarray(x), jnp.asarray(t)))
        jconv = JQConv(GATE[1], (3, 3), min_channels=GATE[2])
        gp = jsharding.shard_params({"kernel": kernel, "bias": bias}, mesh, 1)
        want["gate"] = np.asarray(jax.jit(lambda p, x: jconv.apply({"params": p}, x))(
            gp, jnp.asarray(gx)))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    tmp = os.path.dirname(procs[0].args[-1])
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(4)]
    return outs, want, params


# each cut net's quantized convs, by kind: TINY's residual blocks' 3x3 convs
QUANTIZED = {"int8": {"QConv": 20}, "int8_pallas": {"FusedQConv3x3": 18}}


@pytest.mark.parametrize("case", ["int8", "int8_pallas", "int8_bf16", "int8_pallas_bf16"])
def test_quantized_conv_calls_bit_equal_to_the_uncut_net(tp_run, case):
    """Every quantized conv of the cut net ran on its rank's half of the
    output channels, and its gathered output is the uncut conv's on the
    same arguments, bit for bit (the bias slice in the kernel's epilogue).
    The control, the bias added after the gather in the compute dtype,
    differs from it in bf16 on K3's convs, whose epilogue adds the bias in
    fp32 before the one rounding; in fp32 the two orders round alike, and
    the s8 conv's epilogue adds the bias in the compute dtype after its
    rounding, as use_tpu's QConv does, so there the control cannot fail."""
    outs, _, _ = tp_run
    quant = case.removesuffix("_bf16")
    for out in outs:
        calls = out[case]["calls"]
        assert {kind: c["calls"] for kind, c in calls.items()} == QUANTIZED[quant]
        for kind, c in calls.items():
            assert c["bit_equal"] == c["calls"] and c["max_abs_err"] == 0.0, (kind, c)
            assert all(int(k.split(" of ")[0]) * 2 == int(k.split(" of ")[1])
                       for k in c["out_channels"])
            if case == "int8_pallas_bf16":
                assert c["control_bit_equal"] < c["calls"]
            else:
                assert c["control_bit_equal"] == c["calls"]


@pytest.mark.parametrize("quant", ["int8", "int8_pallas"])
def test_cut_int8_forward_matches_jax_sharded_apply(tp_run, quant):
    """Each data rank's lanes: the cut forward is the uncut port net's, bit
    for bit, and within MODEL_REL_L2 of use_tpu's apply over its sharded
    params."""
    outs, want, _ = tp_run
    for out in outs:
        got, full = out[quant]["y"], out[quant]["y_full"]
        assert torch.isfinite(got).all()
        assert torch.equal(got, full)
        w = want[quant][out["data_rank"] * 2:(out["data_rank"] + 1) * 2]
        rel = np.linalg.norm(got.numpy() - w) / np.linalg.norm(w)
        assert rel <= MODEL_REL_L2, rel


@pytest.mark.parametrize("quant", ["int8", "int8_pallas"])
def test_cut_int8_sample_equals_the_uncut_sample(tp_run, quant):
    """A 2-step pc sample of the cut int8 score model, the same draws: the
    uncut one's, bit for bit."""
    outs, _, _ = tp_run
    for out in outs:
        got, want = out[quant]["sample"], out[quant]["sample_full"]
        assert got.shape == (2, 15 * 16) and torch.isfinite(got).all()
        assert torch.equal(got, want)


@pytest.mark.parametrize("quant", ["int8", "int8_pallas"])
def test_shard_then_gather_round_trips(tp_run, quant):
    """The cut int8 net, loaded with convert_jax.ncsnpp_params_to_shards
    (the int8 nets' state dict is the fp32 net's), gathers use_tpu's params
    converted, bit for bit, on every rank."""
    outs, _, params = tp_run
    want = ncsnpp_params_to_state_dict(params[quant])
    for out in outs:
        got = out[quant]["gathered_before"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        assert len(out[quant]["sharded"]) == 42


def test_qconv_gate_reads_the_whole_output_width(tp_run):
    """O 32 cut to 16 a rank, min_channels 24: the slice quantizes, as the
    whole conv does; bit-equal to the uncut conv, and use_tpu's sharded
    QConv within its op tolerance."""
    outs, want, _ = tp_run
    for out in outs:
        got = out["gate"]
        assert got["sharded"] == ["weight"]
        assert got["local_out"] == 16 < GATE[2] and got["quantizes"]
        assert torch.equal(got["y"], got["y_full"])
        assert_close(nchw_to_nhwc(got["y"]), want["gate"], OP_RTOL, OP_ATOL)
