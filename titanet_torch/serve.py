"""Minimal speaker service: embed / enroll / verify / identify over HTTP
(port of the JAX package's ``examples/serve.py``).

:class:`titanet_torch.train.extractor.SpeakerEmbedder` (bucketed batching,
every bucket run once by ``warmup()`` before the first request) behind
:class:`titanet_torch.train.enroll.SpeakerRegistry` (profiles, open-set
decisions, optional calibrated-LLR thresholds), on a standard-library
HTTP server. Runs on the card unless ``--device cpu`` is given.

    python -m titanet_torch.serve [--port 8077] [--checkpoint-dir <run dir>] &
    curl -s --data-binary @utt.wav http://127.0.0.1:8077/embed | head -c 200
    curl -s --data-binary @utt.wav 'http://127.0.0.1:8077/enroll?name=ada'
    curl -s --data-binary @utt2.wav 'http://127.0.0.1:8077/verify?name=ada'
    curl -s --data-binary @utt2.wav http://127.0.0.1:8077/identify

``--model-size`` names the model: TitaNet ``s|m|l`` (default ``s``) or
another family of the zoo at its published width, ``ecapa512``,
``ecapa1024``, ``xvector``, ``resnet`` or ``conformer``, as the JAX
package's ``examples/serve.py`` parses it. ``--fast-frontend`` runs the
fused log-mel kernel with bf16 operands (the tensor-core
``logmel_tc_kernel``); the default frontend is plain torch in f32.
``--quantized`` embeds through the int8 encoder (TitaNet only).
"""

from __future__ import annotations

import argparse
import json
import os
from http.server import BaseHTTPRequestHandler, HTTPServer

BUCKETS = (16000, 32000, 48000, 96000)
_FAMILIES = ("ecapa", "xvector", "resnet", "conformer")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m titanet_torch.serve")
    parser.add_argument("--port", type=int, default=8077)
    parser.add_argument("--model-size", default="s",
                        help="s|m|l (TitaNet), ecapa512|ecapa1024, xvector, resnet or conformer")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--n-classes", type=int, default=251)
    parser.add_argument("--fast-frontend", action="store_true",
                        help="fused log-mel kernel with bf16 operands (serving precision)")
    parser.add_argument("--quantized", action="store_true",
                        help="int8 encoder (4x weight compression)")
    parser.add_argument("--ema", action="store_true",
                        help="serve EMA weights from an EMA-trained checkpoint (training.ema_decay > 0)")
    parser.add_argument("--registry", default=None,
                        help="JSON path for the speaker registry (loaded if present, saved after each enroll)")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="accept threshold (raw cosine; an LLR floor when the loaded registry "
                             "carries calibration)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def build_family(model_size: str, device):
    """The model ``--model-size`` names with random weights from seed 0:
    TitaNet ``s|m|l``, or a family of the zoo at its published width."""
    from titanet_torch import models

    if model_size.startswith("ecapa"):
        return models.get_ecapa(channels=int(model_size[len("ecapa"):] or 512), device=device)
    if model_size in ("xvector", "resnet", "conformer"):
        return getattr(models, f"get_{model_size}")(device=device)
    return models.get_titanet(model_size=model_size, device=device)


def build_embedder(args):
    """The service's ``SpeakerEmbedder`` from parsed arguments: the model of
    ``--model-size`` with random weights from seed 0, or the newest
    checkpoint under ``--checkpoint-dir`` (a TitaNet's depth and widths
    read from its weights; another family at its published width), warmed
    up on every bucket."""
    import torch

    from titanet_torch._device import resolve_device
    from titanet_torch.ops.frontend import FrontendConfig
    from titanet_torch.train.extractor import SpeakerEmbedder

    family = args.model_size.startswith(_FAMILIES)
    if family and args.quantized:
        raise SystemExit("--quantized is TitaNet-only (int8 PTQ tree)")
    dev = resolve_device(args.device)
    cfg = (
        FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
        if args.fast_frontend
        else FrontendConfig.from_ms()
    )
    if not args.checkpoint_dir:
        model = build_family(args.model_size, dev)
    else:
        from titanet_torch.losses.heads import build_head
        from titanet_torch.models.titanet import _SIZE_PRESETS
        from titanet_torch.train import checkpoint as ckpt
        from titanet_torch.train.state import create_train_state, ema_eval_state, make_optimizer
        from titanet_torch.utils.torch_compat import titanet_from_state_dict

        epoch = ckpt.latest_epoch(args.checkpoint_dir)
        if epoch is None:
            raise FileNotFoundError(args.checkpoint_dir)
        data = ckpt.read_checkpoint(args.checkpoint_dir, epoch)
        # the model as the run built it, in the state a run of the default
        # optimizer with a "ce" head of --n-classes saves: a checkpoint of
        # another family, shape or optimizer fails to load, never loads in
        # part. A TitaNet's depth and widths come from its weights
        # (--model-size must name its width); another family is built at
        # the width --model-size names.
        if family:
            model = build_family(args.model_size, dev)
        else:
            model = titanet_from_state_dict(data["model"], device=dev)
            hidden = _SIZE_PRESETS.get(args.model_size.lower(), {}).get("encoder_hidden_size")
            if model.encoder.prolog.conv.weight.shape[0] != hidden:
                raise ValueError(f"--model-size {args.model_size}: the checkpoint under {args.checkpoint_dir} "
                                 f"holds a TitaNet of hidden size {model.encoder.prolog.conv.weight.shape[0]}")
        state = create_train_state(
            model, build_head("ce", model.embedding_size, args.n_classes, device=dev,
                              generator=torch.Generator().manual_seed(0)),
            make_optimizer(), ema=args.ema,
        )
        model = ema_eval_state(ckpt.load_state_dict(state, data)).model
        print(f"serving checkpoint epoch {epoch}" + (" (EMA weights)" if args.ema else ""))
    emb = SpeakerEmbedder(model, cfg, buckets=list(BUCKETS), batch_size=args.batch_size,
                          quantized=args.quantized, device=dev)
    emb.warmup()
    return emb


def make_handler(embedder, registry=None, sample_rate=16000, registry_path=None):
    """The request handler class over ``embedder`` and ``registry``. A body
    that does not decode, a missing ``name`` or an unknown speaker is
    answered with 400 and the error, never a crash."""
    from urllib.parse import parse_qs, urlparse

    from titanet_torch.data.audio_io import read_wav

    class Handler(BaseHTTPRequestHandler):
        def _embed_body(self):
            import tempfile

            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                f.write(body)
                f.flush()
                wav, sr = read_wav(f.name)
            if sr != sample_rate:
                from titanet_torch.data.loader import _resample_host

                wav = _resample_host(wav[0], sr, sample_rate)[None]
            return embedder.embed([wav[0]])[0]

        def _reply(self, code, obj):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            url = urlparse(self.path)
            route = url.path
            qs = parse_qs(url.query)
            if route not in ("/embed", "/enroll", "/verify", "/identify"):
                self.send_error(404)
                return
            try:
                vec = self._embed_body()
                if route == "/embed":
                    self._reply(200, {"embedding": vec.tolist(), "dim": len(vec)})
                    return
                if registry is None:
                    raise ValueError("no registry on this server")
                if route == "/enroll":
                    name = qs["name"][0]
                    registry.enroll(name, vec)
                    if registry_path:
                        registry.save(registry_path)
                    self._reply(200, {"enrolled": name, "speakers": registry.speakers})
                elif route == "/verify":
                    name = qs["name"][0]
                    accept, score = registry.verify(name, vec)
                    self._reply(200, {"speaker": name, "accept": accept, "score": score})
                else:  # /identify
                    top = registry.identify(vec, top_k=3)[0]
                    self._reply(200, {"candidates": [{"speaker": s, "score": sc} for s, sc in top]})
            except Exception as e:  # malformed input -> 400, never crash
                self._reply(400, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def main(argv=None):
    args = build_parser().parse_args(argv)
    embedder = build_embedder(args)
    from titanet_torch.train.enroll import SpeakerRegistry

    if args.registry and os.path.exists(args.registry):
        registry = SpeakerRegistry.load(args.registry)
    else:
        registry = SpeakerRegistry(threshold=args.threshold)
    server = HTTPServer(
        ("127.0.0.1", args.port),
        make_handler(embedder, registry, registry_path=args.registry),
    )
    print(f"speaker service on http://127.0.0.1:{server.server_port}/{{embed,enroll,verify,identify}}")
    server.serve_forever()


if __name__ == "__main__":
    main()
