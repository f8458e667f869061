"""The cell's inputs, made from --seed on the device in a few large calls.

One general generator reads a configuration's layouts and a traffic mix's
parameters (both data files) and makes the requests of a run:

- a layout is a list of pieces of the description track: ["narration",
  seconds] (or frames, at the feature level) of fresh content, or
  ["content", v0, v1] (optionally with a resampling ratio [p, q]) copied
  from the video's content;
- the traffic mix says how many base pairs a run makes ("rotate"), which
  layout set a request takes ("layout_set": one pair a request in
  "single" mode, all of the set's pairs in "batch" mode), by how much the
  leading narration of each pair varies with the seed ("lead_jitter_s"),
  and how much of each track's start a request cuts off ("cut_max_s"):
  request i of a run takes base request (i + o) mod rotate, o drawn from
  the seed, with its own cuts of both tracks, drawn from the seed, as
  views of the base arrays. So no two requests of a run hold the same
  input (the cuts move the samples' phase against the 210-sample frames
  and the true map with them), while every seed gets the same sizes and
  the same shape buckets. With "content_seed" the base pairs themselves
  (content, narration, lead-ins) come from that seed and not from --seed:
  every --seed then gets the same work, in another order and with other
  cuts.

PCM pairs use the speech-like signal of the repository's synthetic media
(utils/synthmedia.speech_like: broadband noise, a wandering one-pole
tilt, syllable- and phrase-rate envelopes, never silent), written here in
torch: the same layouts and statistics and int16 output, not the same
bits. Feature pairs use film_pair.synth_feature_stream's smoothed
unit-variance noise at 4 +/- 2. Each pair also carries its ground-truth
segments (audio_start, audio_end, video_start, video_end) in seconds,
which the reference reads.
"""
import math

import numpy as np
import torch

MASK64 = (1 << 64) - 1
TWO_PI = 2.0 * math.pi


def derive(seed, *tags):
    """A 63-bit seed from any whole number and integer tags (splitmix64),
    so that --seed beyond 32 bits and each piece's stream stay distinct."""
    x = _mix(seed & MASK64)
    for tag in tags:
        x = _mix((x + (tag & MASK64)) & MASK64)
    return x >> 1


def _mix(x):
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def speech_like(n, seed, amp, sr, device):
    """(n,) float64 speech-like signal (utils/synthmedia.speech_like's
    recipe): white noise through a one-pole filter whose coefficient
    wanders, under syllable- and phrase-rate envelopes with seeded rates
    and phases, scaled to standard deviation ~amp."""
    g = _generator(seed, device)
    u = torch.rand(6, generator=g, device=device,
                   dtype=torch.float64).tolist()
    white = torch.randn(n + 1, generator=g, device=device,
                        dtype=torch.float64)
    walk = torch.randn(n, generator=g, device=device,
                       dtype=torch.float64).cumsum_(0).mul_(2e-4)
    t = torch.arange(n, device=device, dtype=torch.float64).div_(sr)
    tilt = torch.sin(t * (TWO_PI / (1.2 + 1.2 * u[0])) + 6.28 * u[1])
    x = white[1:] + (0.6 + 0.3 * tilt) * white[:-1]
    del white, tilt
    env = torch.sin(t * (TWO_PI * (2.8 + 1.8 * u[2])) + 6.28 * u[3] + walk)
    env = 0.35 + 0.65 * (0.5 + 0.5 * env)
    env *= 0.55 + 0.45 * torch.sin(
        t * (TWO_PI * (0.25 + 0.3 * u[4])) + 6.28 * u[5]) ** 2
    return x.mul_(env).mul_(amp / float(x.std()))


def resample(x, p, q):
    """x resampled by p / q (band-limited, through the FFT): a ratio
    above 1 slows the content down, as resample_poly(x, p, q) does."""
    n = x.shape[0]
    m = int(round(n * p / q))
    spec = torch.fft.rfft(x)
    out = torch.zeros(m // 2 + 1, dtype=spec.dtype, device=x.device)
    k = min(spec.shape[0], out.shape[0])
    out[:k] = spec[:k]
    return torch.fft.irfft(out, n=m).mul_(m / n)


def _to_i16(x):
    return x.round_().clamp_(-32768, 32767).to(torch.int16)


# film_pair.synth_feature_stream's ~8-frame smoothing
_TAPS = np.hanning(17)[1:-1].astype(np.float32)
_TAPS /= _TAPS.sum()
_SMOOTH_STD = float(np.sqrt(np.sum(_TAPS.astype(np.float64) ** 2)))


def feature_stream(n, seed, streams, device):
    """(streams, n) float32 feature streams: uniform unit-variance noise
    smoothed by the 15-tap window, at 4 +/- 2 (film_pair's recipe)."""
    g = _generator(seed, device)
    x = torch.rand(streams, 1, n, generator=g, device=device,
                   dtype=torch.float32).sub_(0.5).mul_(math.sqrt(12.0))
    taps = torch.from_numpy(_TAPS).to(device).view(1, 1, -1)
    half = len(_TAPS) // 2
    sm = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x, (half, half)), taps)
    return sm.view(streams, n).mul_(2.0 / _SMOOTH_STD).add_(4.0)


class Pair:
    """One input pair: video and audio (int16 (1, samples) PCM, or lists
    of float32 feature streams), the true segments in seconds, the
    description's length in seconds, and the tracks' true lengths in
    210-fps frames (the program's len_v and len_a)."""

    def __init__(self, video, audio, segments, audio_s):
        self.video = video
        self.audio = audio
        self.segments = segments
        self.audio_s = audio_s

    def frames(self):
        """(video frames, description frames)."""
        if isinstance(self.video, list):
            return (min(len(f) for f in self.video),
                    min(len(f) for f in self.audio))
        return self.video.shape[1] // 210, self.audio.shape[1] // 210

    def cut(self, k_video, k_audio, rate):
        """The pair with the first k_video units of the video and k_audio
        of the description cut off (views, no copy; rate: units per
        second), its true map shifted with them and clipped at the
        video's new start."""
        if isinstance(self.video, list):
            video = [f[k_video:] for f in self.video]
            audio = [f[k_audio:] for f in self.audio]
        else:
            video = self.video[:, k_video:]
            audio = self.audio[:, k_audio:]
        dv, da = k_video / rate, k_audio / rate
        segments = []
        for a0, a1, v0, v1 in self.segments:
            a0, a1, v0, v1 = a0 - da, a1 - da, v0 - dv, v1 - dv
            if v1 <= 0.0:
                continue
            if v0 < 0.0:
                a0 -= v0 * (a1 - a0) / (v1 - v0)
                v0 = 0.0
            segments.append((a0, a1, v0, v1))
        return Pair(video, audio, segments, self.audio_s - da)


def _lead_jitter(seed_pair, jitter_s):
    rng = np.random.default_rng(derive(seed_pair, 0xD1))
    return float(rng.uniform(-jitter_s, jitter_s)) if jitter_s else 0.0


def pcm_pair(config, layout, seed_pair, jitter_s, device):
    sr = config["sample_rate"]
    content = speech_like(int(layout["content_s"] * sr),
                          derive(seed_pair, 0), config["content_amp"], sr,
                          device)
    jitter = _lead_jitter(seed_pair, jitter_s)
    pieces, segments, cursor = [], [], 0
    for k, piece in enumerate(layout["pieces"]):
        if piece[0] == "narration":
            n = int(round((piece[1] + (jitter if k == 0 else 0.0)) * sr))
            pieces.append(_to_i16(speech_like(
                n, derive(seed_pair, 1 + k), config["narration_amp"], sr,
                device)))
            cursor += n
            continue
        i0, i1 = int(piece[1] * sr), int(piece[2] * sr)
        seg = content[i0:i1]
        if len(piece) > 3:
            seg = resample(seg, *piece[3])
        segments.append((cursor / sr, (cursor + seg.shape[0]) / sr,
                         i0 / sr, i1 / sr))
        pieces.append(_to_i16(seg.clone()))
        cursor += seg.shape[0]
    video = _to_i16(content)[None].cpu().numpy()
    audio = torch.cat(pieces)[None].cpu().numpy()
    return Pair(video, audio, segments, audio.shape[1] / sr)


def feature_pair(config, layout, seed_pair, jitter_s, device):
    fps, streams = config["fps"], config["streams"]
    content = feature_stream(layout["content_frames"], derive(seed_pair, 0),
                             streams, device)
    jitter = int(round(_lead_jitter(seed_pair, jitter_s) * fps))
    pieces, segments, cursor = [], [], 0
    for k, piece in enumerate(layout["pieces"]):
        if piece[0] == "narration":
            n = piece[1] + (jitter if k == 0 else 0)
            pieces.append(feature_stream(n, derive(seed_pair, 1 + k),
                                         streams, device))
            cursor += n
            continue
        c0, c1 = piece[1], piece[2]
        segments.append((cursor / fps, (cursor + c1 - c0) / fps, c0 / fps,
                         c1 / fps))
        pieces.append(content[:, c0:c1])
        cursor += c1 - c0
    video = list(content.cpu().numpy())
    audio = list(torch.cat(pieces, dim=1).cpu().numpy())
    return Pair(video, audio, segments, cursor / fps)


MAKERS = {"pcm": pcm_pair, "features": feature_pair}


def make_requests(config, traffic, seed, device):
    """The run's base requests, each a list of Pairs: `rotate` requests of
    one pair ("single" mode, the set's layouts in turn) or of the whole
    layout set ("batch" mode)."""
    layouts = config["layouts"][traffic["layout_set"]]
    make = MAKERS[config["level"]]
    jitter = traffic.get("lead_jitter_s", 0.0)
    seed = traffic.get("content_seed", seed)
    requests = []
    for r in range(traffic["rotate"]):
        if traffic["mode"] == "single":
            chosen = [(r % len(layouts), layouts[r % len(layouts)])]
        else:
            chosen = list(enumerate(layouts))
        requests.append([make(config, layout, derive(seed, r, j), jitter,
                              device) for j, layout in chosen])
    return requests


class Requests:
    """The requests of one run, in order: request i is base request
    (i + o) mod rotate with both tracks of each pair cut by their own
    amounts (under cut_max_s), o and the cuts drawn from the seed;
    i = 0, 1, 2, ... in turn."""

    def __init__(self, config, traffic, seed, device):
        self.base = make_requests(config, traffic, seed, device)
        self.rate = (config["sample_rate"] if config["level"] == "pcm"
                     else config["fps"])
        self.cut_max = int(traffic.get("cut_max_s", 0.0) * self.rate)
        self._rng = np.random.default_rng(derive(seed, 0xC07))
        self._next = derive(seed, 0x0D) % len(self.base)

    def warm_up(self):
        """The first base request, uncut: the cell's shapes."""
        return self.base[0]

    def next(self):
        base = self.base[self._next % len(self.base)]
        self._next += 1
        if not self.cut_max:
            return base
        cuts = self._rng.integers(0, self.cut_max, size=(len(base), 2))
        return [p.cut(int(kv), int(ka), self.rate)
                for p, (kv, ka) in zip(base, cuts)]
