"""Port parity: the dry-run (``launch/dryrun.py``) against the reference's.

The port's side runs in two spawned processes on fake process groups
(``_torch_dist_workers.dryrun_worker``: each makes its own fake groups
of 256, 512 and 1 ranks and imports the port only); the reference's
side in a third (``_torch_dryrun_reference.py``, whose 512-device XLA
flag must precede JAX's start). All three start before the tests run
and work in parallel.

Held here:
  - ``make_hooks`` and ``input_specs`` equal the reference's, as specs,
    shapes and dtypes, for every arch x shape on both production meshes;
  - every reduced config's train, prefill and decode cell runs on the
    fake 16 x 16 mesh (the train cell raised in the projections'
    einsum before the DTensor flatten fault was repaired), and its
    ``decode_32k`` argument bytes per device equal the reference's
    compiled module's;
  - a reduced train_4k cell with a large vocab (split over "model", and
    not) keeps its temp per device below the global logits' float32
    bytes (B x S x V x 4): the cross-entropy's gradient keeps the
    logits' placement;
  - ``long_500k`` is skipped with the reference's reason, and
    ``lsgaussian`` is an error in both;
  - on a (1, 1) mesh the per-device FLOPs equal ``FlopCounterMode``'s
    count of the same step run unsharded on real tensors, exactly;
  - a hand-built DTensor program's collectives are counted exactly;
  - the reduced encdec and vlm configs (``_torch_family_configs``) get
    the reference's input specs (frames, vision) and decode_32k cell
    arguments (parameters, tokens, the cache with its ``enc_out``
    stand-in), as shapes and dtypes.
"""
import json
import os
import re
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _torch_dist_workers as W
from _torch_family_configs import FAMILY_CONFIGS
from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import dryrun as TD
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT

CELLS = ("train_4k", "prefill_32k", "decode_32k")
# (arch, vocab) of the train_4k cells whose logits dominate their temp
VOCAB_CELLS = [("yi-9b", 16384), ("minicpm3-4b", 16383)]
# (name, seq, batch, kind) of the (1, 1) cells held against FlopCounterMode
ONE_DEVICE = ("one", 32, 4, None)
STATUS = [(a, "long_500k") for a in ARCH_IDS] + [("lsgaussian", "train_4k"),
                                                 ("lsgaussian", "long_500k")]
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    one = [(a, ONE_DEVICE[:3] + (kind,)) for a in ARCH_IDS
           for kind in ("train", "prefill", "decode")]
    jobs = [W.Spawned(W.dryrun_worker, 1, tmp_path_factory.mktemp(name),
                      payload, gloo=False)
            for name, payload in (
                ("cells", {"archs": ARCH_IDS, "shapes": CELLS,
                           "vocab_cells": [(a, "train_4k", v)
                                           for a, v in VOCAB_CELLS]}),
                ("rest", {"full": ARCH_IDS, "status": STATUS,
                          "one_device": one}))]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_dryrun_reference.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         check=True)
    cells, rest = (job.result() for job in jobs)
    return dict(rest, cells=cells["cells"]), \
        json.loads(ref.stdout.splitlines()[-1])


def _norm(spec):
    """A spec as JSON gives it back: tuples as lists."""
    return json.loads(json.dumps(spec))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_hooks_equal_the_reference(runs, multi_pod):
    got, ref = runs
    n = 0
    for arch in ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            want = ref["hooks"][f"{arch}|{shape}|{multi_pod}"]
            assert _norm(got["hooks"][arch, shape, multi_pod]) == want, \
                (arch, shape)
            n += len(want)
    print("hooks compared", n)


def test_input_specs_equal_the_reference(runs):
    got, ref = runs
    for arch in ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for decode in (False, True):
                key = (arch, shape) + (("decode",) if decode else ())
                port = {k: [list(s), d.replace("torch.", "")]
                        for k, (s, d) in got["inputs"][key].items()}
                assert port == ref["inputs"][f"{arch}|{shape}|{decode}"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cells_run_on_16x16(runs, arch):
    got, _ = runs
    for shape in CELLS:
        r = got["cells"][arch, shape]
        print(arch, shape, r["status"], r.get("run_s"), r.get("flops"),
              r.get("collective_counts"))
        assert r["status"] == "ok", r.get("error")
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] > 0
    # the train step updates the state in place, decode the cache
    train = got["cells"][arch, "train_4k"]["memory"]
    assert 0 < train["alias_size_in_bytes"] < train["argument_size_in_bytes"]
    assert got["cells"][arch, "prefill_32k"]["memory"][
        "alias_size_in_bytes"] == 0


@pytest.mark.parametrize("arch,vocab", VOCAB_CELLS)
def test_train_temp_below_the_global_logits(runs, arch, vocab):
    """A reduced train_4k cell with a vocab large enough that the logits
    dominate: 16,384 splits over "model" (16), 16,383 does not (as
    minicpm3-4b's 73,448): the temp per device stays below the global
    logits' float32 bytes either way."""
    got, _ = runs
    shape = get_shape("train_4k")
    logits = shape.global_batch * shape.seq_len * vocab * 4
    r = got["cells"][arch, "train_4k", vocab]
    assert r["status"] == "ok", r.get("error")
    temp = r["memory"]["temp_size_in_bytes"]
    print(arch, vocab, "train_4k temp", temp, "global logits", logits)
    assert temp < logits


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_argument_bytes_equal_the_reference(runs, arch):
    got, ref = runs
    status, want = ref["decode_args"][arch]
    port = got["cells"][arch, "decode_32k"]["memory"]["argument_size_in_bytes"]
    print(arch, "argument bytes per device", port, want)
    assert status == "ok"
    assert port == want


def test_statuses_equal_the_reference(runs):
    got, ref = runs
    for arch, shape in STATUS:
        r = got["status"][arch, shape]
        want_status, want_reason = ref["status"][f"{arch}|{shape}"]
        assert r["status"] == want_status, (arch, shape)
        if want_status == "skipped":
            assert r["reason"] == want_reason
    assert got["status"]["lsgaussian", "train_4k"]["status"] == "error"


def _unsharded_flops(arch, kind):
    """FlopCounterMode's count of the ONE_DEVICE cell run on one device
    with real tensors."""
    cfg = get_config(arch).reduced()
    _, seq, b, _ = ONE_DEVICE
    tokens = torch.zeros((b, seq), dtype=torch.int32)
    if kind == "train":
        state = TT.init_train_state(cfg, device="cpu")
        step = TT.make_train_step(cfg, TO.OptimizerConfig())
        with FlopCounterMode(display=False) as fc:
            step(state, {"tokens": tokens, "labels": tokens})
        return fc.get_total_flops()
    params = TM.init_params(cfg, device="cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if kind == "prefill":
            TM.forward(params, {"tokens": tokens}, cfg, build_cache=True)
        else:
            cache = TM.init_cache(cfg, b, seq, device="cpu")
            TM.decode_step(params, tokens[:, :1], cache, cfg)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_device_flops_equal_flop_counter(runs, arch):
    got, _ = runs
    for kind in ("train", "prefill", "decode"):
        want = _unsharded_flops(arch, kind)
        print(arch, kind, got["one_device"][arch, kind], want)
        assert got["one_device"][arch, kind] == want, (arch, kind)


def test_collectives_of_a_known_program(runs):
    got, _ = runs
    nbytes, counts = got["program"]
    # all-gather result: the (256, 64) float32 rows; all-reduce result:
    # the (8, 8) sum; reduce-scatter result: 32 / 16 = 2 rows of 8.
    assert nbytes == {"all-gather": 256 * 64 * 4, "all-reduce": 8 * 8 * 4,
                      "reduce-scatter": 2 * 8 * 4, "all-to-all": 0.0,
                      "collective-permute": 0.0}
    assert counts == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
                      "all-to-all": 0, "collective-permute": 0}


def _dotted(path):
    """A reference tree path (``jax.tree_util.keystr``) as the port's
    dotted name: "['encoder'][0]['attn']['wk']" -> "encoder.0.attn.wk"."""
    return ".".join(re.findall(r"[A-Za-z_0-9]+", path))


def _specs(named):
    return {name: [list(t.shape), str(t.dtype).replace("torch.", "")]
            for name, t in named}


def test_family_inputs_and_decode_args_equal_the_reference(runs):
    """encdec's frames and vlm's vision inputs, and the decode_32k cell's
    (params, tokens, cache) before placement, against the reference's
    ``build_cell`` arguments; the cache index is the port's host int."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, ref = runs
    shape = get_shape("decode_32k")
    for name, want in ref["families"].items():
        cfg = ArchConfig(**FAMILY_CONFIGS[name]).reduced()
        for decode in (False, True):
            got = _specs(TD.input_specs(cfg, shape,
                                        for_decode=decode).items())
            assert got == {_dotted(k): v for k, v in
                           want["inputs"][str(decode)].items()}, \
                (name, decode)
        with FakeTensorMode():
            params = TM.init_params(cfg, device="cpu")
            cache = TD.decode_cache(cfg, shape, "cpu")
        tokens = TD.input_specs(cfg, shape, for_decode=True)["tokens"]
        assert _specs(params.named_parameters()) == {
            _dotted(k): v for k, v in want["params"].items()}, name
        assert _specs([("", tokens)]) == want["tokens"]
        leaves = []
        for field, v in cache._asdict().items():
            if isinstance(v, tuple):
                leaves += [(f"{field}.{k}", t) for k, t in v._asdict().items()]
            elif isinstance(v, torch.Tensor):
                leaves.append((field, v))
        assert cache.index == 0
        assert _specs(leaves) == {_dotted(k): v for k, v in
                                  want["cache"].items() if k != "['index']"}
