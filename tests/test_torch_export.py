"""The port's policy export and serving (diffrl_tpu_torch.utils.export,
diffrl_tpu_torch.serve_policy) against the JAX package's, on the CPU.

The artifact round-trips exactly; one artifact, exported from a batch of
4, serves batches of 1, 3 and 4096 (torch.export specializes a batch of
1, so none is exported from); a JAX SHAC checkpoint carried into the port
(utils.convert.checkpoint_from_jax) gives shac_policy_fn actions equal to
JAX's shac_policy_fn at rtol/atol 1e-6 (float32 MLPs, sums reassociated);
the server on a free local port answers /act with those actions, 404 on
another path and 400 with a JSON error on a bad body.
"""

import json
import pickle
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffrl_tpu.models.mlp import ActorStochasticMLP as JActor
from diffrl_tpu.utils import export as jexport
from diffrl_tpu.utils.running_mean_std import RunningMeanStd as JRMS

from diffrl_tpu_torch import serve_policy
from diffrl_tpu_torch.models import ActorStochasticMLP
from diffrl_tpu_torch.utils.convert import checkpoint_from_jax
from diffrl_tpu_torch.utils.export import (Policy, export_fn, load_exported,
                                           shac_policy_fn)

torch.set_num_threads(1)
CFG = {"params": {"network": {"actor": "ActorStochasticMLP",
                              "actor_mlp": {"units": [16, 16]}}}}


def _policy():
    gen = torch.Generator().manual_seed(0)
    actor = ActorStochasticMLP(5, 2, CFG["params"]["network"], device="cpu",
                               generator=gen)
    return Policy(actor, torch.linspace(-1, 1, 5), torch.linspace(0.5, 2, 5))


def _obs(n, seed):
    return torch.as_tensor(np.random.RandomState(seed).randn(n, 5)
                           .astype(np.float32))


@torch.no_grad()
def test_export_roundtrip_exact(tmp_path):
    policy, obs = _policy(), _obs(7, 0)
    path = str(tmp_path / "p.pt2")
    data = export_fn(policy, (obs,), path=path)
    assert open(path, "rb").read() == data
    assert torch.equal(load_exported(path)(obs), policy(obs))


@torch.no_grad()
def test_export_batch_polymorphic():
    policy = _policy()
    loaded = load_exported(export_fn(policy, (torch.zeros(4, 5),)))
    for batch in (1, 3, 4096):
        obs = _obs(batch, batch)
        torch.testing.assert_close(loaded(obs), policy(obs), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="at least 2"):
        export_fn(policy, (torch.zeros(1, 5),))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX SHAC checkpoint (actor and obs_rms, as the JAX trainer pickles
    them), JAX's policy of it, and the port's checkpoint carried from it."""
    d = tmp_path_factory.mktemp("ckpt")
    actor = JActor(5, 2, CFG["params"]["network"])
    params = actor.init(jax.random.PRNGKey(0))
    rms = JRMS.create((5,)).update(
        jnp.arange(50, dtype=jnp.float32).reshape(10, 5))
    ckpt = str(d / "best_policy.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump({"actor": jax.tree.map(np.asarray, params),
                     "obs_rms": jax.tree.map(np.asarray, rms)}, f)
    jpolicy, _, _ = jexport.shac_policy_fn(ckpt, CFG)
    with open(ckpt, "rb") as f:
        state = pickle.load(f)
    port = str(d / "best_policy.pt")
    checkpoint_from_jax(state, CFG, port)
    return jpolicy, port


@torch.no_grad()
def test_shac_policy_fn_of_a_jax_checkpoint(jax_checkpoint):
    jpolicy, port = jax_checkpoint
    policy, obs_dim, act_dim = shac_policy_fn(port, CFG, device="cpu")
    assert (obs_dim, act_dim) == (5, 2)
    obs = _obs(4, 1)
    np.testing.assert_allclose(policy(obs).numpy(),
                               np.asarray(jpolicy(obs.numpy())),
                               rtol=1e-6, atol=1e-6)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_answers_act(jax_checkpoint, tmp_path, capsys):
    jpolicy, port_ckpt = jax_checkpoint
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(json.dumps(CFG))            # YAML reads JSON
    artifact = str(tmp_path / "policy.pt2")
    serve_policy.main(["--cfg", str(cfg), "--checkpoint", port_ckpt,
                       "--out", artifact, "--device", "cpu"])
    assert "exported policy (5 obs -> 2 act)" in capsys.readouterr().out
    server = serve_policy.make_server(load_exported(artifact), 0, "cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        obs = _obs(3, 2).numpy()
        code, body = _post(url + "/act", json.dumps(
            {"obs": obs.tolist()}).encode())
        assert code == 200
        np.testing.assert_allclose(np.array(json.loads(body)["actions"]),
                                   np.asarray(jpolicy(obs)), rtol=1e-6,
                                   atol=1e-6)
        code, body = _post(url + "/act", json.dumps(
            {"obs": obs[0].tolist()}).encode())
        assert code == 200 and len(json.loads(body)["actions"]) == 1
        assert _post(url + "/other", b"{}")[0] == 404
        code, body = _post(url + "/act", b"not json")
        assert code == 400 and "error" in json.loads(body)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
