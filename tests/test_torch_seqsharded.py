"""The sequence-sharded decode (``decode_attention_seqsharded``,
``decode_step(mesh=, seq_sharded=True)``) on two gloo ranks on the CPU,
against the JAX package's ``shard_map`` version on two emulated XLA host
devices (one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``, as the JAX dry run
gets its devices) and, where the unsharded path computes the same (no
window, ``cache_len < S``), against the port's ``decode_attention``.

The ranks and the reference run in subprocesses (``tests/_dist_ranks.py``),
each with a timeout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import _dist_ranks as dr  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import decode_step  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)  # as test_torch_flash_attn's decode_attention
NAMES = [c[0] for c in dr.SEQ_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    return dr.run_ranks("seq", 2, tmp, timeout=150), dr.run_jax("jax_seq", 2, tmp, timeout=200)


@pytest.mark.parametrize("name", NAMES)
def test_matches_the_jax_shard_map(runs, name):
    ranks, ref = runs
    r0, r1 = (r["cases"][name] for r in ranks)
    # the combined output is on every rank
    np.testing.assert_array_equal(r0["out"].numpy(), r1["out"].numpy())
    np.testing.assert_allclose(r0["out"].numpy(), ref[name + "/out"], **TOL)
    # the owner shard's insert, and no write at cache_len = S: bit for bit
    for kv in ("k", "v"):
        got = torch.cat([r0[kv], r1[kv]], dim=1).numpy()
        np.testing.assert_array_equal(got, ref[f"{name}/{kv}"])


@pytest.mark.parametrize("name", [n for n, *_r, lens, _i in dr.SEQ_CASES if max(lens) < dr.SEQ_S])
def test_matches_the_unsharded_decode(runs, name):
    ranks, _ = runs
    i = NAMES.index(name)
    c = dr.seq_case(i)
    k, v = c["k"].copy(), c["v"].copy()
    lens = c["lens"]
    if c["kn"] is not None:
        for b, n in enumerate(lens):
            k[b, n], v[b, n] = c["kn"][b, 0], c["vn"][b, 0]
        lens = lens + 1
    want = decode_attention(*(torch.from_numpy(a) for a in (c["q"], k, v, lens)))
    np.testing.assert_allclose(ranks[0]["cases"][name]["out"].numpy(), want.numpy(), **TOL)


def test_the_cache_full_case_writes_nowhere(runs):
    """At ``cache_len = S`` the reference writes no shard (the unsharded
    decode would clamp into the last slot)."""
    ranks, _ = runs
    c = dr.seq_case(NAMES.index("full_no_write"))
    got = torch.cat([r["cases"]["full_no_write"]["k"] for r in ranks], dim=1).numpy()
    np.testing.assert_array_equal(got, c["k"])


def test_zamba2_seq_sharded_serve_steps_match_jax(runs):
    ranks, ref = runs
    for r in ranks:
        np.testing.assert_array_equal(r["zamba"]["tokens"].numpy(), ref["zamba/tokens"])
        np.testing.assert_allclose(r["zamba"]["logits"].numpy(), ref["zamba/logits"], **TOL)
        np.testing.assert_array_equal(r["zamba"]["len"].numpy(), ref["zamba/len"])
    for kv in ("g_k", "g_v"):
        got = torch.cat([r["zamba"][kv] for r in ranks], dim=2).numpy()
        np.testing.assert_allclose(got, ref["zamba/" + kv], **TOL)


def test_zamba2_seq_sharded_serve_steps_match_the_unsharded_port(runs):
    ranks, _ = runs
    cfg = get_config("zamba2_1p2b").reduced()
    tree, cache_np, tok = dr.zamba_inputs()
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    tok = torch.from_numpy(tok)
    for step in range(dr.ZAMBA_STEPS):
        logits, cache = decode_step(cfg, params, tok, cache)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        np.testing.assert_allclose(ranks[0]["zamba"]["logits"][step].numpy(),
                                   logits[:, -1].numpy(), **TOL)
        np.testing.assert_array_equal(ranks[0]["zamba"]["tokens"][:, step], tok[:, 0].numpy())


def test_decode_cache_from_prefill_builds_one_sequence_shard():
    """``seq_shard=(i, n)`` allocates rank i's positions alone; the shards
    side by side are the whole cache, the SSM states and ``len`` whole on
    each; a windowed (ring) cache has no sequence shards."""
    from repro_torch.launch.steps import decode_cache_from_prefill, make_prefill_step
    from repro_torch.models import init_params

    cfg = get_config("zamba2_1p2b").reduced()
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 20), generator=torch.Generator().manual_seed(1))
    _, pcache = make_prefill_step(cfg)(params, {"tokens": tokens})
    whole = decode_cache_from_prefill(cfg, pcache, 20, 32)
    shards = [decode_cache_from_prefill(cfg, pcache, 20, 32, seq_shard=(i, 2)) for i in range(2)]
    for k in ("g_k", "g_v"):
        assert shards[0][k].shape[2] == 16
        torch.testing.assert_close(torch.cat([s[k] for s in shards], dim=2), whole[k],
                                   rtol=0, atol=0)
    for s in shards:
        for k in ("g_state", "len"):
            torch.testing.assert_close(s[k], whole[k], rtol=0, atol=0)
    with pytest.raises(ValueError):
        decode_cache_from_prefill(cfg, pcache, 20, 33, seq_shard=(0, 2))
    mixtral = get_config("mixtral_8x22b").reduced()
    with pytest.raises(ValueError):
        decode_cache_from_prefill(mixtral, None, 4, 32, seq_shard=(0, 2))
