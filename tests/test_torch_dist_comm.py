"""Port parity: the int8 compressed all-reduce
(``distributed/compression.py``) and the GPipe pipeline
(``distributed/pipeline.py``) on four CPU ranks (gloo), against the JAX
reference.

``compressed_psum`` runs for 6 steps on a (4, 256) seeded gradient, one
row a rank, against the reference under ``jax.vmap(..., axis_name=
"data")``, op by op: q and the residuals are exact; the mean is within 2 ulp of
its magnitude (the scales' sum may add in another order). The
reference test's intent holds too: each step's error stays under 0.2 x
max|exact|, and error feedback keeps the 6 steps' accumulated error
under 1.2 x max|exact|.

``pipeline_apply`` (8 tanh layers, batch 8 x 4 x 16, 4 microbatches)
runs on (pod 2 x data 2) and (pod 4 x data 1) against the sequential
loop and the reference's ``pipeline_apply`` (in a JAX subprocess on 8
host devices, as ``tests/test_pipeline.py`` runs it): within 1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_workers as W
from repro.distributed import compression as JC
from repro_torch.distributed import pipeline as TP

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
L_, B_, S_, D_ = 8, 8, 4, 16
NUM_MICRO = 4

_REF_PIPELINE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.distributed.pipeline import pipeline_apply

    d = np.load(sys.argv[1])
    w, b, x = (jnp.asarray(d[k]) for k in ("w", "b", "x"))

    def layer(lp, h):
        wi, bi = lp
        return jax.nn.tanh(h @ wi + bi)

    out = {}
    for pods, data in ((2, 4), (4, 2)):
        mesh = jax.make_mesh((pods, data), ("pod", "data"))
        y = pipeline_apply(layer, (w, b), x, mesh=mesh, num_micro=%d)
        out[str(pods)] = np.asarray(y).tolist()
    print(json.dumps(out))
""" % NUM_MICRO)


@pytest.fixture(scope="module")
def comm(tmp_path_factory):
    d = tmp_path_factory.mktemp("comm")
    rng = np.random.default_rng(0)
    grads = (rng.normal(size=(4, 256)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(L_, D_, D_)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(L_, D_)) * 0.1).astype(np.float32)
    x = rng.normal(size=(B_, S_, D_)).astype(np.float32)
    np.savez(d / "pipe.npz", w=w, b=b, x=x)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(_REPO, "src"), JAX_PLATFORMS="cpu")
    ref_pipe = subprocess.Popen(
        [sys.executable, "-c", _REF_PIPELINE, str(d / "pipe.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    (d / "spawn").mkdir()
    job = W.Spawned(W.comm_worker, 4, d / "spawn",
                    {"grads": grads, "steps": STEPS, "w": w, "b": b, "x": x,
                     "num_micro": NUM_MICRO})

    # op by op, as the reference's arithmetic reads: under jit, XLA fuses
    # x - q * scale into one rounding, where the code asks for two
    f = jax.vmap(lambda g, r: JC.compressed_psum(g, "data", r),
                 axis_name="data")
    qf = jax.vmap(JC.quantize_int8)
    res = jnp.zeros_like(grads)
    ref_steps = []
    for _ in range(STEPS):
        q, _ = qf(grads + res)
        mean, res = f(grads, res)
        ref_steps.append({"mean": np.asarray(mean), "res": np.asarray(res),
                          "q": np.asarray(q)})
    out, err = ref_pipe.communicate(timeout=600)
    assert ref_pipe.returncode == 0, err[-3000:]
    ref_pipes = {int(k): np.asarray(v, np.float32)
                 for k, v in json.loads(out.strip().splitlines()[-1]).items()}
    return job.result(), ref_steps, ref_pipes, grads


def test_compressed_psum_matches_reference(comm):
    got, want, _, _ = comm
    for i, (g, r) in enumerate(zip(got["steps"], want)):
        assert g["means_equal"], i
        np.testing.assert_array_equal(g["q"], r["q"], err_msg=f"step {i}")
        np.testing.assert_array_equal(g["res"], r["res"],
                                      err_msg=f"step {i}")
        ulp = np.spacing(np.abs(r["mean"]).max().astype(np.float32))
        dev = np.abs(g["mean"] - r["mean"][0]).max()
        print("step", i, "mean off by", dev / ulp, "ulp")
        assert dev <= 2 * ulp, (i, dev, ulp)
        # every row of the reference's vmap is the same mean
        assert (r["mean"] == r["mean"][0]).all()


def test_compressed_psum_error_feedback(comm):
    got, _, _, grads = comm
    exact = grads.mean(0)
    scale = max(float(np.abs(exact).max()), 1e-6)
    errs, accum = [], np.zeros_like(exact)
    for g in got["steps"]:
        err = g["mean"] - exact
        accum += err
        errs.append(float(np.abs(err).max()))
    print("per-step error / max|exact|", [e / scale for e in errs],
          "accumulated", float(np.abs(accum).max()) / scale)
    assert max(errs) < 0.2 * scale, errs
    assert np.abs(accum).max() < 6 * 0.2 * scale


def test_compressed_psum_grads_tree(comm):
    """Over a tree: each mean keeps its gradient's dtype, and the
    dequantized value plus the residual is the input exactly."""
    got = comm[0]["tree"]
    assert got["dtype_kept"] and got["exact"]


@pytest.mark.parametrize("pods", [2, 4])
def test_pipeline_matches_sequential_and_reference(comm, pods):
    got, _, ref_pipes, _ = comm
    out = got["pipes"][(pods, 4 // pods)]
    seq = got["sequential"]
    print("pods", pods, "vs sequential", np.abs(out - seq).max(),
          "vs reference", np.abs(out - ref_pipes[pods]).max())
    np.testing.assert_allclose(out, seq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, ref_pipes[pods], rtol=0, atol=1e-5)


def test_bubble_fraction():
    assert TP.bubble_fraction(1, 4) == 0.0
    assert abs(TP.bubble_fraction(2, 8) - 1 / 9) < 1e-9
    assert TP.bubble_fraction(4, 4) == pytest.approx(3 / 7)
