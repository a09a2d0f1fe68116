"""The port's speaker service (titanet_torch/serve.py) on the CPU: the
cases of tests/test_serve.py on ``titanet_torch.serve.make_handler`` over
a real local HTTP server, the port's ``SpeakerEmbedder`` behind the
handler (``/embed`` equals a direct embed), and ``build_embedder``'s
model families, checkpoint restore, refusals and device rule."""

import json
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import small_titanet_pair
from titanet_torch import serve
from titanet_torch.data.audio_io import write_wav
from titanet_torch.losses.heads import build_head
from titanet_torch.models import get_titanet
from titanet_torch.train import checkpoint as ckpt
from titanet_torch.train.enroll import SpeakerRegistry
from titanet_torch.train.extractor import SpeakerEmbedder
from titanet_torch.train.state import create_train_state, make_optimizer
from titanet_tpu.train.enroll import SpeakerRegistry as JaxRegistry


class _StubEmbedder:
    """Deterministic waveform -> unit embedding (tests/test_serve.py's)."""

    def embed(self, waveforms):
        out = []
        for w in waveforms:
            spec = np.abs(np.fft.rfft(np.asarray(w)[:8000], 256))[:32]
            out.append(spec / max(np.linalg.norm(spec), 1e-9))
        return np.stack(out)


def _wav_bytes(tmp_path, freq, name, sr=16000, seconds=1.0):
    t = np.arange(int(sr * seconds)) / sr
    path = str(tmp_path / name)
    write_wav(path, (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[None], sr)
    with open(path, "rb") as f:
        return f.read()


def _serve(embedder, registry, reg_path=None):
    httpd = HTTPServer(("127.0.0.1", 0), serve.make_handler(embedder, registry, registry_path=reg_path))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture()
def server(tmp_path):
    reg_path = str(tmp_path / "registry.json")
    httpd, base = _serve(_StubEmbedder(), SpeakerRegistry(threshold=0.5), reg_path)
    yield base, reg_path
    httpd.shutdown()


def test_embed_enroll_verify_identify(server, tmp_path):
    base, reg_path = server
    ada, ada2 = _wav_bytes(tmp_path, 220.0, "ada.wav"), _wav_bytes(tmp_path, 230.0, "ada2.wav")
    bob = _wav_bytes(tmp_path, 1200.0, "bob.wav")
    status, out = _post(base + "/embed", ada)
    assert status == 200 and out["dim"] == 32
    status, out = _post(base + "/enroll?name=ada", ada)
    assert status == 200 and out["speakers"] == ["ada"]
    _post(base + "/enroll?name=bob", bob)
    status, out = _post(base + "/verify?name=ada", ada2)
    assert status == 200 and out["accept"] is True
    status, out = _post(base + "/verify?name=bob", ada2)
    assert status == 200 and out["accept"] is False
    status, out = _post(base + "/identify", bob)
    assert status == 200 and out["candidates"][0]["speaker"] == "bob"
    # persisted after each enroll, readable by both packages
    assert SpeakerRegistry.load(reg_path).speakers == ["ada", "bob"]
    assert JaxRegistry.load(reg_path).speakers == ["ada", "bob"]


def test_malformed_input_is_400_not_crash(server):
    base, _ = server
    status, out = _post(base + "/embed", b"this is not a wav file")
    assert status == 400 and "error" in out
    assert _post(base + "/verify?name=ghost", b"nope")[0] == 400
    assert _post(base + "/enroll", b"nope")[0] == 400
    req = urllib.request.Request(base + "/nowhere", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req)
    assert err.value.code == 404


def test_port_embedder_behind_the_handler(tmp_path):
    """The port's SpeakerEmbedder (small TitaNet, CPU) behind the handler:
    ``/embed`` of a 16 kHz WAV equals ``embed`` on the decoded samples, an
    8 kHz WAV is resampled first, and a served enroll/identify round trip
    names the enrolled speaker."""
    from titanet_torch.data.audio_io import read_wav
    from titanet_torch.data.loader import _resample_host

    _, _, tmodel = small_titanet_pair(seed=4)
    embedder = SpeakerEmbedder(tmodel, buckets=[16000, 32000], batch_size=2, device="cpu")
    httpd, base = _serve(embedder, SpeakerRegistry(threshold=0.5))
    try:
        for name, sr in (("a.wav", 16000), ("b.wav", 8000)):
            body = _wav_bytes(tmp_path, 330.0, name, sr=sr, seconds=1.3)
            status, out = _post(base + "/embed", body)
            wav, got_sr = read_wav(str(tmp_path / name))
            wav = wav[0] if got_sr == 16000 else _resample_host(wav[0], got_sr, 16000)
            assert status == 200 and out["dim"] == 192
            np.testing.assert_allclose(out["embedding"], embedder.embed([wav])[0], atol=1e-6)
        assert _post(base + "/enroll?name=ada", _wav_bytes(tmp_path, 220.0, "e.wav"))[0] == 200
        status, out = _post(base + "/identify", _wav_bytes(tmp_path, 220.0, "i.wav", seconds=1.5))
        assert status == 200 and out["candidates"][0]["speaker"] == "ada"
        assert _post(base + "/embed", b"RIFF....WAVE")[0] == 400
    finally:
        httpd.shutdown()


def _args(*argv):
    return serve.build_parser().parse_args(list(argv))


def test_build_embedder_restores_a_checkpoint_and_refuses_another(tmp_path, monkeypatch):
    """``--checkpoint-dir``: a checkpoint of the default optimizer with a
    "ce" head of ``--n-classes`` loads whole into a TitaNet of the run's own
    depth (here 2 mega-blocks; ``--model-size`` names the width), and the
    served model holds its weights (``warmup`` runs before the first
    request); one trained with another optimizer, or of another width than
    ``--model-size``, fails to load."""
    warmed = []
    monkeypatch.setattr(SpeakerEmbedder, "warmup", lambda self: warmed.append(self))
    model = get_titanet(model_size="s", n_mega_blocks=2, device="cpu", generator=torch.Generator().manual_seed(7))
    for name, opt in (("adam", make_optimizer()), ("sgd", make_optimizer(name="sgd"))):
        state = create_train_state(model, build_head("ce", 192, 5, device="cpu"), opt)
        ckpt.save_checkpoint(str(tmp_path / name), 2, state)
    emb = serve.build_embedder(_args("--checkpoint-dir", str(tmp_path / "adam"), "--n-classes", "5",
                                     "--fast-frontend", "--device", "cpu"))
    assert warmed == [emb] and emb.buckets == list(serve.BUCKETS) and emb.batch_size == 8
    assert emb.frontend.use_pallas_fused and emb.frontend.precision == "default"
    for (k, v), (_, w) in zip(emb.model.state_dict().items(), model.state_dict().items()):
        assert torch.equal(v, w), k
    assert emb.model.n_mega_blocks == 2
    with pytest.raises(ValueError, match="disagree|tensors|shape"):
        serve.build_embedder(_args("--checkpoint-dir", str(tmp_path / "sgd"), "--n-classes", "5",
                                   "--device", "cpu"))
    with pytest.raises(ValueError, match="hidden size 256"):
        serve.build_embedder(_args("--checkpoint-dir", str(tmp_path / "adam"), "--n-classes", "5",
                                   "--model-size", "m", "--device", "cpu"))
    with pytest.raises(RuntimeError, match="size mismatch"):
        serve.build_embedder(_args("--checkpoint-dir", str(tmp_path / "adam"), "--n-classes", "9",
                                   "--device", "cpu"))
    with pytest.raises(FileNotFoundError):
        serve.build_embedder(_args("--checkpoint-dir", str(tmp_path / "none"), "--device", "cpu"))


FAMILY_SIZES = {"ecapa512": ("EcapaTdnn", 6189568), "ecapa1024": ("EcapaTdnn", 14654784),
                "xvector": ("XVector", 3394644), "resnet": ("SpeakerResNet", 6306592),
                "conformer": ("MfaConformer", 20021952)}


@pytest.mark.parametrize("size", sorted(FAMILY_SIZES))
def test_build_embedder_serves_every_model_size_family(size, monkeypatch):
    """``--model-size ecapa512|ecapa1024|xvector|resnet|conformer`` builds
    that family at its published width (the parameter counts of the JAX
    package's models, tests/test_torch_<family>.py), random weights from
    seed 0, warmed up; it embeds a request to a unit vector."""
    warmed = []
    monkeypatch.setattr(SpeakerEmbedder, "warmup", lambda self: warmed.append(self))
    emb = serve.build_embedder(_args("--model-size", size, "--device", "cpu"))
    cls, n_params = FAMILY_SIZES[size]
    assert type(emb.model).__name__ == cls and sum(p.numel() for p in emb.model.parameters()) == n_params
    assert warmed == [emb] and not emb.model.training
    vec = emb.embed([np.random.default_rng(0).standard_normal(12000).astype(np.float32) * 0.1])
    assert vec.shape == (1, 192) and abs(np.linalg.norm(vec) - 1.0) < 1e-5


@pytest.mark.parametrize("size", sorted(FAMILY_SIZES))
def test_quantized_is_titanet_only(size):
    with pytest.raises(SystemExit, match="TitaNet-only"):
        serve.build_embedder(_args("--model-size", size, "--quantized", "--device", "cpu"))


def test_build_embedder_restores_a_family_checkpoint_and_refuses_another(tmp_path, monkeypatch):
    """An x-vector run's checkpoint serves under ``--model-size xvector``
    with its weights; under ``resnet`` or ``s`` it fails to load."""
    monkeypatch.setattr(SpeakerEmbedder, "warmup", lambda self: None)
    from titanet_torch.models import get_xvector

    model = get_xvector(device="cpu", generator=torch.Generator().manual_seed(3))
    ckpt.save_checkpoint(str(tmp_path / "xv"), 1, create_train_state(model, build_head("ce", 192, 5, device="cpu"),
                                                                     make_optimizer()))
    emb = serve.build_embedder(_args("--model-size", "xvector", "--checkpoint-dir", str(tmp_path / "xv"),
                                     "--n-classes", "5", "--device", "cpu"))
    for (k, v), (_, w) in zip(emb.model.state_dict().items(), model.state_dict().items()):
        assert torch.equal(v, w), k
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        serve.build_embedder(_args("--model-size", "resnet", "--checkpoint-dir", str(tmp_path / "xv"),
                                   "--n-classes", "5", "--device", "cpu"))
    with pytest.raises(KeyError):
        serve.build_embedder(_args("--checkpoint-dir", str(tmp_path / "xv"), "--n-classes", "5", "--device", "cpu"))


def test_build_embedder_needs_a_card_unless_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_embedder(_args())
