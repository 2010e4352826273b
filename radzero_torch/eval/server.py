"""HTTP serving front-end over the ServingEngine (port of
radzero_tpu/eval/server.py, the same endpoints and JSON).

A threaded stdlib HTTP server exposing the micro-batched engine
(eval/serving.py). Endpoints:

- ``GET /healthz``            -> {"status": "ok", "prompt_sets": [...]}
- ``GET /prompt_sets``        -> registered sets and their prompts
- ``POST /predict?prompt_set=NAME[&maps=none|patch|full]``
      body: raw JPEG bytes (Content-Type: image/jpeg) or a decoded
      image as JSON {"image": [[...]]}.
      -> {"probs": [...], "prompts": [...],
          "similarity_maps": [[...]] | null}

Concurrency model: the HTTP layer is a ThreadingHTTPServer — each
request thread submits to the engine and blocks on its Future, so
requests arriving together ride the same device micro-batch (that is
the engine's whole point). stdlib-only; for production put any
load-balancer/TLS terminator in front.

Usage:
    server = EngineServer(engine, prompts={"cxr14": [...]})
    server.start(port=8080)           # background thread
    ...
    server.stop()

or end to end on the card, from a converted checkpoint
(radzero_torch.tools.convert_checkpoint), from an exported bundle
(eval/export.py) or from random weights (seed 0):
    python -m radzero_torch.eval.server --ckpt CONVERTED_DIR --prompts_json P.json \
        --port 8080
    python -m radzero_torch.eval.server --bundle BUNDLE_DIR --prompts_json P.json \
        --port 8080
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from radzero_torch.eval.serving import ServingEngine
from radzero_torch.utils.logging import logger


class _Handler(BaseHTTPRequestHandler):
    server_ref: "EngineServer" = None  # set per-class by EngineServer

    # ------------------------------------------------------------------
    def _json(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        srv = type(self).server_ref
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, {"status": "ok",
                             "prompt_sets": sorted(srv.prompts)})
        elif path == "/prompt_sets":
            self._json(200, srv.prompts)
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def do_POST(self):  # noqa: N802
        srv = type(self).server_ref
        url = urlparse(self.path)
        if url.path != "/predict":
            self._json(404, {"error": f"unknown path {url.path}"})
            return
        q = parse_qs(url.query)
        prompt_set = q.get("prompt_set", [None])[0]
        maps = q.get("maps", ["none"])[0]
        if prompt_set not in srv.prompts:
            self._json(400, {"error": f"unknown prompt_set {prompt_set!r}"})
            return
        if maps not in ("none", "patch", "full"):
            self._json(400, {"error": f"maps must be none|patch|full, got {maps!r}"})
            return
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        ctype = self.headers.get("Content-Type", "application/octet-stream")
        try:
            if ctype.startswith("application/json"):
                image = np.asarray(json.loads(body)["image"], np.uint8)
            else:
                image = bytes(body)  # JPEG bytes
            fut = srv.engine.submit(image, prompt_set, want_maps=maps)
            out = fut.result(timeout=srv.request_timeout)
        except Exception as e:
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        resp = {
            "prompts": srv.prompts[prompt_set],
            "probs": np.asarray(out["probs"]).tolist(),
            "similarity_maps": (
                np.asarray(out["similarity_maps"]).tolist()
                if out["similarity_maps"] is not None else None
            ),
        }
        self._json(200, resp)

    def log_message(self, fmt, *args):  # route through our logger
        logger.debug("http: " + fmt % args)


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of clients beyond it, and each retries after a 1 s (then 3 s)
    # TCP timeout, which shows as whole seconds of latency
    request_queue_size = 256


class EngineServer:
    def __init__(
        self,
        engine: ServingEngine,
        prompts: Dict[str, List[str]],
        request_timeout: float = 120.0,
    ):
        self.engine = engine
        self.prompts = dict(prompts)
        self.request_timeout = request_timeout
        for name, plist in self.prompts.items():
            engine.register_prompt_set(name, plist)
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_port

    def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})
        self._httpd = _Server((host, port), handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info(f"serving on {host}:{self.port}")
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()
        return False


def main(argv=None):
    import argparse
    import os

    import torch

    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer, load_tokenizer

    ap = argparse.ArgumentParser(
        description="Serve RadZero zero-shot predictions over HTTP from a converted checkpoint "
                    "(--ckpt), an exported bundle (--bundle) or, with neither, from random "
                    "weights (seed 0) at the default configuration (a smoke server: its "
                    "answers mean nothing).")
    ap.add_argument("--ckpt", help="converted checkpoint dir (radzero_torch.tools."
                                   "convert_checkpoint): state.pt, and vocab.txt / "
                                   "processor_config.json where the snapshot had them")
    ap.add_argument("--config", help="with --ckpt: model_config JSON (the YAML "
                                     "model.model_config block) for a checkpoint whose dims "
                                     "are not the flagship's")
    ap.add_argument("--bundle", help="AOT bundle dir from radzero_torch.eval.export (cold start)")
    ap.add_argument("--tokenizer", help="vocab.txt, a dir holding one, or an HF tokenizer name; "
                                        "default: the --ckpt dir when it holds vocab.txt, else "
                                        "the hash tokenizer")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--prompts_json", help='{"set_name": ["There is X", ...]}; required with '
                                           "--bundle, each set holding the bundle's n_prompts")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt and args.bundle:
        ap.error("pass --ckpt or --bundle, not both")
    if args.ckpt and not os.path.isfile(os.path.join(args.ckpt, "state.pt")):
        ap.error(f"--ckpt {args.ckpt} holds no state.pt: convert the snapshot with "
                 "python -m radzero_torch.tools.convert_checkpoint")
    if args.config and not args.ckpt:
        ap.error("--config goes with --ckpt")

    prompts = {"default": ["There is pneumothorax"]}
    if args.prompts_json:
        with open(args.prompts_json) as f:
            prompts = json.load(f)

    if args.bundle:
        with open(f"{args.bundle}/bundle.json") as f:
            meta = json.load(f)
        if not args.prompts_json:
            ap.error(f"--bundle needs --prompts_json: the bundle was exported for sets of "
                     f"{meta['n_prompts']} prompts")
        tok = (load_tokenizer(args.tokenizer, max_length=meta["max_tokens"]) if args.tokenizer
               else WhitespaceHashTokenizer(vocab_size=meta["vocab_size"],
                                            max_length=meta["max_tokens"]))
        engine = ServingEngine.from_bundle(args.bundle, tok, device=args.device)
    else:
        from radzero_torch.eval.serving import ImageSpec

        image_spec = None
        if args.ckpt:
            from radzero_torch.models.configuration import radzero_config_from_dict
            from radzero_torch.tools.run_real_checkpoint import (
                build_processor,
                checkpoint_tokenizer,
                load_converted,
            )

            cfg = None
            if args.config:
                with open(args.config) as f:
                    cfg = radzero_config_from_dict(json.load(f))
            params, cfg = load_converted(args.ckpt, cfg=cfg)
            proc = build_processor(args.ckpt)
            image_spec = ImageSpec(size=proc.size, mean=tuple(proc.mean), std=tuple(proc.std))
            tok = checkpoint_tokenizer(args.ckpt, args.tokenizer, vocab_size=cfg.text.vocab_size)
        else:
            from radzero_torch.models.configuration import RadZeroConfig
            from radzero_torch.models.radzero import init_radzero

            cfg = RadZeroConfig()
            params = init_radzero(torch.Generator(device=args.device).manual_seed(0), cfg)
            tok = (load_tokenizer(args.tokenizer, max_length=64) if args.tokenizer else
                   WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64))
        engine = ServingEngine(params, cfg, tok, device=args.device, max_batch=32,
                               dtype=torch.bfloat16, channels=1, image_spec=image_spec)

    with engine, EngineServer(engine, prompts) as server:
        server.engine.warmup()
        server.start(host=args.host, port=args.port)
        threading.Event().wait()  # serve until killed


if __name__ == "__main__":
    main()
