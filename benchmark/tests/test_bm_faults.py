"""With the timed path broken underneath, a whole run's `correct` comes out
false: a step that returns its state unchanged (the live phase carry), half
of a batch left out (the rest repeated in its place), and an answer
altered where it is produced.  (No cell spans chips: no exchange to drop.)"""
import torch

from conftest import run_cell


def test_carry_left_unchanged(monkeypatch):
    from mbexwn_vocoder_torch.parallel.streaming import StreamingSynthesizer

    chunk = StreamingSynthesizer._chunk

    def stuck(self, mel_span, carry, left, inner):
        audio, _ = chunk(self, mel_span, carry, left, inner)
        return audio, carry

    monkeypatch.setattr(StreamingSynthesizer, "_chunk", stuck)
    r = run_cell("speech-live")
    assert r["correct"] is False and r["checks"]["audio_rel"]["value"] > r["checks"]["audio_rel"]["limit"]


def test_half_batch_left_out(monkeypatch):
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

    synth = PipelinedSynthesizer._synthesize

    def half(self, mell):
        y = synth(self, mell[: max(1, mell.shape[0] // 2)])
        return torch.cat([y] * (mell.shape[0] // y.shape[0]), dim=0)

    monkeypatch.setattr(PipelinedSynthesizer, "_synthesize", half)
    r = run_cell("speech-offline")
    assert r["correct"] is False


def test_answer_altered(monkeypatch):
    from mbexwn_vocoder_torch.models.pan_wavenet import PaNWaveNet

    infer = PaNWaveNet.infer

    def altered(self, *args, **kwargs):
        return infer(self, *args, **kwargs) * 1.1

    monkeypatch.setattr(PaNWaveNet, "infer", altered)
    r = run_cell("speech-offline")
    assert r["correct"] is False
