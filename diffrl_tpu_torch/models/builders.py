"""Config-built networks: conv trunks, LSTM/GRU cells and discrete heads
(port of diffrl_tpu/models/builders.py, the counterpart of rl_games'
A2CBuilder network family).

The YAML ``network`` tree builds an ``A2CNetwork`` (an nn.Module):

.. code-block:: yaml

    network:
      separate: False            # shared or separate actor/critic trunks
      space:
        continuous: {fixed_sigma: True, sigma_init: {val: 0}}
        # or: discrete: {}       # one categorical logits head
        # or: multi_discrete: {} with action_dims = [n1, n2, ...]
      cnn:
        activation: relu
        convs:
          - {filters: 32, kernel_size: 8, strides: 4}
      mlp: {units: [256, 128], activation: elu}
      rnn: {name: lstm, units: 256, layers: 1, before_mlp: False}

Observations of a conv trunk are NHWC, as in the JAX package; each layer
is an ``nn.Conv2d`` (OIHW weights, VALID padding) applied to the NCHW
view, and the features are flattened in NHWC order, so a JAX HWIO weight
w carries over as w.permute(3, 2, 0, 1). The LSTM and GRU cells are
written out with JAX's parameters (wi [G U, d], wh [G U, U], one bias
[G U]), its gate order (LSTM i, f, g, o; GRU r, z, n) and its GRU form
n = tanh(x W_n + b_n + r * (h W_hn)) with no second bias. Everything is
float32; random draws come from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import default_device
from .mlp import _ACTIVATIONS, MLP

# ---------------------------------------------------------------------------
# conv trunk
# ---------------------------------------------------------------------------


def init_conv(in_channels: int, convs: Sequence[Dict[str, int]], device=None,
              generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    """The conv stack: one Conv2d per spec (filters, kernel_size, strides),
    orthogonal over the flattened receptive field with gain sqrt(2) (the
    JAX package's initializer), zero bias."""
    device = default_device(device)
    layers = nn.ModuleList()
    c_in = in_channels
    for spec in convs:
        c_out, ks = int(spec["filters"]), int(spec["kernel_size"])
        conv = nn.Conv2d(c_in, c_out, ks, stride=int(spec["strides"]),
                         device=device)
        with torch.no_grad():
            w = torch.empty((c_out, ks * ks * c_in), device=device)
            nn.init.orthogonal_(w, gain=math.sqrt(2.0), generator=generator)
            conv.weight.copy_(w.reshape(c_out, ks, ks, c_in)
                              .permute(0, 3, 1, 2))
            conv.bias.zero_()
        layers.append(conv)
        c_in = c_out
    return layers


def apply_conv(layers: nn.ModuleList, x, activation: str = "relu"):
    """x [..., H, W, C] (NHWC) -> flattened features [..., F] in NHWC
    order."""
    act = _ACTIVATIONS[activation]
    batch_shape = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    for conv in layers:
        x = act(conv(x))
    return x.permute(0, 2, 3, 1).reshape(batch_shape + (-1,))


def conv_output_dim(in_shape: Tuple[int, int, int],
                    convs: Sequence[Dict[str, int]]) -> int:
    h, w, c = in_shape
    for spec in convs:
        ks, st = int(spec["kernel_size"]), int(spec["strides"])
        h = (h - ks) // st + 1
        w = (w - ks) // st + 1
        c = int(spec["filters"])
    return h * w * c


# ---------------------------------------------------------------------------
# recurrent cells
# ---------------------------------------------------------------------------


class RNNLayer(nn.Module):
    """One layer's parameters: wi [G U, d], wh [G U, U], b [G U]."""

    def __init__(self, gates: int, in_dim: int, units: int, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.wi = nn.Parameter(torch.empty((gates * units, in_dim),
                                           device=device))
        self.wh = nn.Parameter(torch.empty((gates * units, units),
                                           device=device))
        self.b = nn.Parameter(torch.zeros(gates * units, device=device))
        with torch.no_grad():
            nn.init.orthogonal_(self.wi, generator=generator)
            nn.init.orthogonal_(self.wh, generator=generator)


def _init_rnn(gates, in_dim, units, layers, device, generator):
    device = default_device(device)
    stack = nn.ModuleList()
    d = in_dim
    for _ in range(layers):
        stack.append(RNNLayer(gates, d, units, device, generator))
        d = units
    return stack


def init_lstm(in_dim: int, units: int, layers: int = 1, device=None,
              generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    return _init_rnn(4, in_dim, units, layers, device, generator)


def init_gru(in_dim: int, units: int, layers: int = 1, device=None,
             generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    return _init_rnn(3, in_dim, units, layers, device, generator)


def lstm_step(layers: nn.ModuleList, x, state):
    """One step through the stacked LSTM; state is a list of (h, c)."""
    new_state = []
    for layer, (h, c) in zip(layers, state):
        gates = x @ layer.wi.T + h @ layer.wh.T + layer.b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        new_state.append((h, c))
        x = h
    return x, new_state


def gru_step(layers: nn.ModuleList, x, state):
    """One step through the stacked GRU; state is a list of (h,)."""
    new_state = []
    for layer, (h,) in zip(layers, state):
        wi_r, wi_z, wi_n = torch.chunk(layer.wi, 3, dim=0)
        wh_r, wh_z, wh_n = torch.chunk(layer.wh, 3, dim=0)
        b_r, b_z, b_n = torch.chunk(layer.b, 3, dim=-1)
        r = torch.sigmoid(x @ wi_r.T + h @ wh_r.T + b_r)
        z = torch.sigmoid(x @ wi_z.T + h @ wh_z.T + b_z)
        n = torch.tanh(x @ wi_n.T + r * (h @ wh_n.T) + b_n)
        h = (1.0 - z) * n + z * h
        new_state.append((h,))
        x = h
    return x, new_state


def mask_hidden(rnn_state, done):
    """The recurrent state with the rows of finished envs zeroed."""
    return [tuple(torch.where(done[:, None], torch.zeros_like(h), h)
                  for h in layer) for layer in rnn_state]


# ---------------------------------------------------------------------------
# categorical distributions (a2c_discrete)
# ---------------------------------------------------------------------------


def categorical_sample(logits, generator: Optional[torch.Generator] = None):
    """One draw per row by the Gumbel-max trick (JAX's
    random.categorical), int64."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def categorical_log_prob(logits, actions):
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def categorical_kl(old_logits, new_logits):
    """KL(old || new), the direction rl_games' scheduler uses."""
    old_lp = torch.log_softmax(old_logits, dim=-1)
    new_lp = torch.log_softmax(new_logits, dim=-1)
    return torch.sum(torch.exp(old_lp) * (old_lp - new_lp), dim=-1)


# ---------------------------------------------------------------------------
# the config-built actor-critic
# ---------------------------------------------------------------------------


class _Trunk(nn.Module):
    """[cnn] -> flatten -> [rnn before the mlp] -> mlp -> [rnn after]."""

    def __init__(self, net: "A2CNetwork", device, generator):
        super().__init__()
        self.cnn = (init_conv(net.obs_shape[-1], net.cnn_cfg["convs"], device,
                              generator)
                    if net.cnn_cfg is not None else None)
        self.rnn = None
        if net.rnn_name == "lstm":
            self.rnn = init_lstm(net._rnn_in, net.rnn_units, net.rnn_layers,
                                 device, generator)
        elif net.rnn_name == "gru":
            self.rnn = init_gru(net._rnn_in, net.rnn_units, net.rnn_layers,
                                device, generator)
        elif net.rnn_name:
            raise ValueError(f"unknown rnn {net.rnn_name}")
        self.mlp = (MLP(net._mlp_dims, net.mlp_activation, device=device,
                        generator=generator, layer_norm=False)
                    if net.mlp_units else None)


class A2CNetwork(nn.Module):
    """Actor-critic assembled from a YAML ``network`` tree (the JAX
    package's A2CNetwork).

    ``forward(obs, rnn_state=None)`` returns ``(head_out, value,
    rnn_state)``: head_out is ``(mu, sigma)`` for a continuous space, the
    logits [.., n] for a discrete one, and a list of logits for a
    multi-discrete one; without a recurrent layer the state passes through
    as given (None). The trunk's MLP has its activation after every layer
    and no LayerNorm; the heads are plain linear layers (orthogonal gain
    0.01, the value's 1).
    """

    def __init__(self, obs_shape, action_dim,
                 cfg_network: Optional[Dict[str, Any]] = None,
                 action_dims: Optional[Sequence[int]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        cfg = cfg_network or {}
        self.obs_shape = ((obs_shape,) if isinstance(obs_shape, int)
                          else tuple(obs_shape))
        self.separate = bool(cfg.get("separate", False))

        space = cfg.get("space", {"continuous": {}})
        if "multi_discrete" in space:
            self.space = "multi_discrete"
            if action_dims is None:
                raise ValueError("multi_discrete needs action_dims")
            self.action_dims = [int(n) for n in action_dims]
        elif "discrete" in space:
            self.space = "discrete"
            self.action_dims = [int(action_dim)]
        else:
            self.space = "continuous"
            self.action_dim = int(action_dim)
            cont = space.get("continuous", {}) or {}
            self.fixed_sigma = bool(cont.get("fixed_sigma", True))
            si = cont.get("sigma_init", {})
            self.sigma_init = float((si or {}).get("val", 0.0) or 0.0)

        self.cnn_cfg = cfg.get("cnn")
        if self.cnn_cfg is not None and len(self.obs_shape) != 3:
            raise ValueError("cnn requires [H, W, C] observations")
        self.cnn_activation = (self.cnn_cfg or {}).get("activation", "relu")

        mlp_cfg = cfg.get("mlp", {})
        self.mlp_units = list(mlp_cfg.get("units", [256, 128]))
        self.mlp_activation = mlp_cfg.get("activation", "elu")

        rnn_cfg = cfg.get("rnn")
        self.rnn_name = (rnn_cfg or {}).get("name")
        self.rnn_units = int((rnn_cfg or {}).get("units", 256)) if rnn_cfg \
            else 0
        self.rnn_layers = int((rnn_cfg or {}).get("layers", 1)) if rnn_cfg \
            else 0
        self.rnn_before_mlp = bool((rnn_cfg or {}).get("before_mlp", False))

        # feature widths through the pipeline
        if self.cnn_cfg is not None:
            feat = conv_output_dim(self.obs_shape, self.cnn_cfg["convs"])
        else:
            feat = int(self.obs_shape[0])
        if self.rnn_name and self.rnn_before_mlp:
            self._rnn_in = feat
            feat = self.rnn_units
        self._mlp_dims = [feat] + self.mlp_units
        feat = self.mlp_units[-1] if self.mlp_units else feat
        if self.rnn_name and not self.rnn_before_mlp:
            self._rnn_in = feat
            feat = self.rnn_units
        self._head_in = feat

        self.trunk = _Trunk(self, device, generator)
        self.trunk_critic = (_Trunk(self, device, generator)
                             if self.separate else None)

        def head(n, gain):
            return MLP([self._head_in, n], device=device, generator=generator,
                       layer_norm=False, gain=gain)

        if self.space == "continuous":
            self.mu = head(self.action_dim, 0.01)
            if self.fixed_sigma:
                self.logstd = nn.Parameter(torch.full(
                    (self.action_dim,), self.sigma_init, dtype=torch.float32,
                    device=device))
            else:
                self.sigma_head = head(self.action_dim, 0.01)
        else:
            self.logits = nn.ModuleList(head(n, 0.01)
                                        for n in self.action_dims)
        self.value = head(1, 1.0)

    def initial_rnn_state(self, batch_shape=()):
        """Zero recurrent state: a list per layer of (h, c) (LSTM) or (h,)
        (GRU), each [*batch_shape, units]; None without a recurrent
        layer."""
        if not self.rnn_name:
            return None
        device = self.value.linears[0].weight.device
        shape = tuple(batch_shape) + (self.rnn_units,)
        n = 2 if self.rnn_name == "lstm" else 1
        return [tuple(torch.zeros(shape, device=device) for _ in range(n))
                for _ in range(self.rnn_layers)]

    def _features(self, trunk: _Trunk, obs, rnn_state):
        x = obs
        step = lstm_step if self.rnn_name == "lstm" else gru_step
        if trunk.cnn is not None:
            x = apply_conv(trunk.cnn, x, self.cnn_activation)
        if self.rnn_name and self.rnn_before_mlp:
            x, rnn_state = step(trunk.rnn, x, rnn_state)
        if trunk.mlp is not None:
            x = _ACTIVATIONS[self.mlp_activation](trunk.mlp(x))
        if self.rnn_name and not self.rnn_before_mlp:
            x, rnn_state = step(trunk.rnn, x, rnn_state)
        return x, rnn_state

    def forward(self, obs, rnn_state=None):
        h, new_state = self._features(self.trunk, obs, rnn_state)
        hc = (self._features(self.trunk_critic, obs, rnn_state)[0]
              if self.separate else h)
        value = self.value(hc)[..., 0]
        if self.space == "continuous":
            mu = self.mu(h)
            if self.fixed_sigma:
                sigma = torch.exp(self.logstd).expand_as(mu)
            else:
                sigma = torch.exp(self.sigma_head(h))
            return (mu, sigma), value, new_state
        logits = [lg(h) for lg in self.logits]
        if self.space == "discrete":
            return logits[0], value, new_state
        return logits, value, new_state

    # -- distributions ------------------------------------------------------

    def sample(self, head_out, generator: Optional[torch.Generator] = None):
        if self.space == "continuous":
            mu, sigma = head_out
            return mu + sigma * torch.randn(mu.shape, generator=generator,
                                            device=mu.device)
        if self.space == "discrete":
            return categorical_sample(head_out, generator)
        return torch.stack([categorical_sample(lg, generator)
                            for lg in head_out], dim=-1)

    def log_prob(self, head_out, actions):
        if self.space == "continuous":
            mu, sigma = head_out
            return torch.sum(-0.5 * ((actions - mu) / sigma) ** 2
                             - torch.log(sigma)
                             - 0.5 * math.log(2.0 * math.pi), dim=-1)
        if self.space == "discrete":
            return categorical_log_prob(head_out, actions)
        return sum(categorical_log_prob(lg, actions[..., i])
                   for i, lg in enumerate(head_out))

    def entropy(self, head_out):
        if self.space == "continuous":
            _, sigma = head_out
            return torch.sum(torch.log(sigma)
                             + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
        if self.space == "discrete":
            return categorical_entropy(head_out)
        return sum(categorical_entropy(lg) for lg in head_out)

    def kl(self, old_head_out, head_out):
        """Mean KL(old || new) over the batch, for the adaptive LR."""
        if self.space == "continuous":
            old_mu, old_sigma = old_head_out
            mu, sigma = head_out
            return torch.mean(torch.sum(
                torch.log(sigma / old_sigma)
                + (old_sigma ** 2 + (mu - old_mu) ** 2) / (2.0 * sigma ** 2)
                - 0.5, dim=-1))
        if self.space == "discrete":
            return torch.mean(categorical_kl(old_head_out, head_out))
        return torch.mean(sum(categorical_kl(o, n)
                              for o, n in zip(old_head_out, head_out)))
