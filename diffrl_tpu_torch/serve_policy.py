"""Export a trained policy with torch.export and serve it over HTTP (the
port's counterpart of examples/serve_policy.py).

Export (reads the training YAML for the network):
    python -m diffrl_tpu_torch.serve_policy --cfg examples/cfg/shac/ant.yaml \\
        --checkpoint logs/.../best_policy.pt --out ant_policy.pt2

Serve (JSON over HTTP, standard library only):
    python -m diffrl_tpu_torch.serve_policy --serve ant_policy.pt2 --port 8080
    curl -X POST localhost:8080/act -d '{"obs": [[0.0, ...]]}'

``POST /act {"obs": [[...], ...]}`` (or one observation) answers
``{"actions": [[...], ...]}``; another path answers 404, a body that is
not such a request 400 with ``{"error": ...}``. Both modes run on CUDA
unless ``--device cpu`` is given; the artifact is exported on, and served
on, that device.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import default_device
from .utils.export import export_fn, load_exported, shac_policy_fn


def do_export(cfg_path: str, checkpoint: str, out: str, device=None):
    """Exports the checkpoint's evaluation policy to ``out``; returns
    (obs_dim, act_dim)."""
    import yaml

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    policy, obs_dim, act_dim = shac_policy_fn(checkpoint, cfg, device)
    dev = next(policy.parameters()).device
    export_fn(policy, (torch.zeros((2, obs_dim), device=dev),), path=out)
    return obs_dim, act_dim


def make_server(policy: Callable, port: int, device=None) -> HTTPServer:
    """An HTTPServer on 127.0.0.1 (not yet serving) that answers POST /act
    with ``policy`` run on ``device``; port 0 takes a free port
    (``server.server_address``)."""
    dev = default_device(device)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/act":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                obs = np.asarray(json.loads(self.rfile.read(length))["obs"],
                                 dtype=np.float32)
                if obs.ndim == 1:
                    obs = obs[None]
                with torch.no_grad():
                    act = policy(torch.as_tensor(obs, device=dev))
                actions = act.cpu().numpy().tolist()
            except Exception as e:  # noqa: BLE001 - a bad request is a 400
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"actions": actions})

        def log_message(self, *args):
            pass

    return HTTPServer(("127.0.0.1", port), Handler)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", help="training YAML (export mode)")
    ap.add_argument("--checkpoint", help="SHAC/BPTT .pt checkpoint (export "
                    "mode)")
    ap.add_argument("--out", default="policy.pt2")
    ap.add_argument("--serve", help="serve an exported artifact")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.serve:
        server = make_server(load_exported(args.serve), args.port,
                             args.device)
        print(f"serving policy on http://127.0.0.1:"
              f"{server.server_address[1]}/act", flush=True)
        try:
            server.serve_forever()
        finally:
            server.server_close()
    elif args.cfg and args.checkpoint:
        obs_dim, act_dim = do_export(args.cfg, args.checkpoint, args.out,
                                     args.device)
        print(f"exported policy ({obs_dim} obs -> {act_dim} act) to "
              f"{args.out}")
    else:
        ap.error("either --serve ARTIFACT or --cfg + --checkpoint")


if __name__ == "__main__":
    main()
