"""Port parity: the LM serving path (``train/serve_step.py`` and
``launch/serve.py``) against the JAX reference, on ``reduced()`` float32
configs (CPU).

Greedy generation from the same weights gives the same token ids for
the four registered archs (the logits agree to ~1e-5, far inside their
top-2 gaps on these seeds). ``serve()``'s returned counts are equal; its
timings are each package's own. The reference's serve-loop quirks, kept
by the port so the dicts agree, are held here: each slot is fed its own
greedy prediction, refilled slots keep their cache rows, one cache index
for the batch stops the loop at ``max_seq - 1`` steps, and ``tok_per_s``
counts finished requests only. A decode write at or past ``max_seq`` is
dropped, as in the reference."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.launch import serve as JL
from repro.models import model as JM
from repro.models import sharding_hooks as jhooks
from repro.train import serve_step as JS
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as TL
from repro_torch.models import model as TM
from repro_torch.models import sharding_hooks as thooks
from repro_torch.train import serve_step as TS

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_hooks():
    """``set_hooks`` is process-global in both packages."""
    jhooks.set_hooks({})
    thooks.set_hooks({})
    yield
    jhooks.set_hooks({})
    thooks.set_hooks({})


def _both(arch, seed=0):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, interop.lm_params_from_numpy(jp, tcfg,
                                                        device="cpu")


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_greedy_generate_token_ids(arch):
    jcfg, tcfg, jp, tp = _both(arch)
    prompt = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    # the reference's loop traced whole: one compile instead of the
    # prefill's op-by-op dispatch
    want = jax.jit(lambda p, t: JS.greedy_generate(
        p, t, jcfg, max_new=6, max_seq=16))(jp, jnp.asarray(prompt))
    got = TS.greedy_generate(tp, torch.tensor(prompt), tcfg, max_new=6,
                             max_seq=16)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["yi-9b", "minicpm3-4b"])
def test_prefill_pads_cache(arch):
    jcfg, tcfg, jp, tp = _both(arch)
    toks = np.arange(14, dtype=np.int32).reshape(2, 7) * 5
    jl, jc = JS.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, max_seq=12)
    tl, tc = TS.prefill(tp, {"tokens": torch.tensor(toks)}, tcfg, max_seq=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc.index == int(jc.index) == 7
    for got, want in zip(tc.kv, jc.kv):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # already at or past max_seq: unchanged
    same = TS._pad_cache_seq(tc, 5)
    assert all(a is b for a, b in zip(same.kv, tc.kv))


# (batch_slots, max_seq, n_requests, prompt_len, max_new)
SERVE_CASES = {
    # the launcher's defaults: 2 rounds of 31 steps, every request done
    "defaults": (4, 64, 8, 16, 16),
    # 15 steps a request, 3 rounds wanted: stops at max_seq - 1 = 23
    "stops_at_max_seq": (2, 24, 6, 8, 8),
    "fewer_requests_than_slots": (4, 32, 3, 4, 5),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_counts_equal(case):
    slots, max_seq, n, prompt_len, max_new = SERVE_CASES[case]
    kw = dict(batch_slots=slots, max_seq=max_seq, n_requests=n,
              prompt_len=prompt_len, max_new=max_new, seed=0)
    want = JL.serve(jget("yi-9b").reduced(), **kw)
    got = TL.serve(tget("yi-9b").reduced(), device="cpu", **kw)
    assert set(got) == set(want)
    assert got["requests_done"] == want["requests_done"]
    assert got["decode_steps"] == want["decode_steps"]
    per_request = prompt_len - 1 + max_new
    for out in (got, want):
        # tok_per_s counts the finished requests' tokens only
        assert out["tok_per_s"] * out["wall_s"] == pytest.approx(
            out["requests_done"] * per_request)
    if case == "stops_at_max_seq":
        assert got["decode_steps"] == max_seq - 1 and \
            got["requests_done"] == 2 < n


def test_serve_feeds_greedy_predictions_into_shared_cache(monkeypatch):
    """The loop's inputs: a slot's first token is its prompt's first,
    after that its own greedy prediction; one index for every slot, and
    a refilled slot's cache rows are not cleared."""
    seen, caches, kept = [], set(), []
    real = TM.decode_step

    def spy(params, tokens, cache, cfg):
        caches.add(id(cache.kv.k))
        if cache.index == 4:          # slot 0 is refilled for this step
            kept.append(bool(cache.kv.k[:, 0, :, :4].abs().sum() > 0))
        seen.append((tokens[:, 0].tolist(), cache.index))
        logits, new = real(params, tokens, cache, cfg)
        seen[-1] += (torch.argmax(logits[:, 0], -1).tolist(),)
        return logits, new

    monkeypatch.setattr(TM, "decode_step", spy)
    out = TL.serve(tget("yi-9b").reduced(), batch_slots=2, max_seq=16,
                   n_requests=3, prompt_len=3, max_new=2, device="cpu")
    assert out["requests_done"] == 3 and out["decode_steps"] == 8
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, 512, 3).tolist() for _ in range(3)]
    assert [idx for _, idx, _ in seen] == list(range(8))
    # slots 0 and 1 start on the last two prompts (queue.pop()); slot 0
    # takes the first prompt at step 4
    assert seen[0][0] == [queue[2][0], queue[1][0]]
    assert seen[4][0][0] == queue[0][0]
    for step in (1, 2, 3, 5, 6, 7):
        assert seen[step][0][0] == seen[step - 1][2][0]
    # one cache for the run; the refilled slot still holds the rows of
    # the request before it
    assert len(caches) == 1 and kept == [True]


def test_decode_past_max_seq_raises():
    """Decoding at and past ``max_seq`` raises nowhere and returns the
    reference's logits: the write is dropped (JAX scatter semantics), the
    cache is left as it was, and the step attends over the whole cache.
    GQA (yi-9b) and MLA (minicpm3-4b), from a full prefilled cache and
    from an empty cache of 4 positions."""
    for arch in ("yi-9b", "minicpm3-4b"):
        jcfg, tcfg, jp, tp = _both(arch)
        dec = jax.jit(lambda p, t, c: JM.decode_step(p, t, c, jcfg))
        toks = np.random.default_rng(2).integers(
            0, tcfg.vocab_size, (2, 9)).astype(np.int32)
        _, jc = JS.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jcfg,
                           max_seq=8)
        _, tc = TS.prefill(tp, {"tokens": torch.tensor(toks[:, :8])}, tcfg,
                           max_seq=8)
        before = [a.clone() for a in tc.kv]
        want, jc2 = dec(jp, jnp.asarray(toks[:, 8:]), jc)
        got, tc2 = TS.decode(tp, torch.tensor(toks[:, 8:]), tc, tcfg)
        assert tc2.index == int(jc2.index) == 9
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        for a, b, ja, jb in zip(tc2.kv, before, jc2.kv, jc.kv):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb))
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)

        jc = JM.init_cache(jcfg, 1, 4)
        tc = TM.init_cache(tcfg, 1, 4, device="cpu")
        for i in range(6):                  # indices 4 and 5 are dropped
            tok = toks[:1, i:i + 1]
            want, jc = dec(jp, jnp.asarray(tok), jc)
            got, tc = TS.decode(tp, torch.tensor(tok), tc, tcfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)
        assert tc.index == int(jc.index) == 6
        for a, b in zip(tc.kv, jc.kv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("arch", ["yi-9b", "minicpm3-4b"])
def test_greedy_generate_past_max_seq(arch):
    """A 6-token prompt with 5 new tokens in a cache of 8: the last two
    decodes write past the end; the ids are the reference's."""
    jcfg, tcfg, jp, tp = _both(arch)
    prompt = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 6)).astype(np.int32)
    want = jax.jit(lambda p, t: JS.greedy_generate(
        p, t, jcfg, max_new=5, max_seq=8))(jp, jnp.asarray(prompt))
    got = TS.greedy_generate(tp, torch.tensor(prompt), tcfg, max_new=5,
                             max_seq=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_main_runs_the_reduced_config(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "starcoder2-7b", "--requests", "2", "--slots",
        "2", "--prompt-len", "4", "--max-new", "3", "--max-seq", "16",
        "--device", "cpu"])
    TL.main()
    out = capsys.readouterr().out
    assert "'requests_done': 2" in out and "'decode_steps': 6" in out
