"""Serving path: raw audio → frame and clip posteriors, eval mode.

Port of ``bsed_tpu/serve.py`` (``make_fast_forward``,
``predict_long_recording``): mel front end → folded stem (blocks 0-2) →
remaining conv blocks → BiGRU → predictor. On CUDA the front end is kernel
K1 (``ops/mel_kernel.py``), each folded block's epilogue is kernel K2
(``ops/stem_epilogue.py``), and so is each remaining block's BatchNorm,
gate and pool where K2's group-pool form takes the layout
(``GroupPoolCNN``), the opt-in fused stem (``use_fused_stem``)
runs block 0 as kernel K5 (``ops/stem_kernel.py``), and every branch runs
the BiGRU in ``bsed_tpu``'s hoisted form with both directions'
recurrences of a layer in one call of kernel K4 (``ops/gru_kernel.py``,
through ``models/rnn.HoistedBiGRU``). Everything else is ordinary
PyTorch/cuDNN, as the JAX package leaves it to XLA. Each kernel's entry
launches it or runs its plain PyTorch version, as
``kernels.launches_on`` decides (CPU tensors, or a card inside
``kernels.plain_versions()``, take the plain versions); nothing here
chooses. A configuration with a BEATs encoder (``ModelConfig.beats``) also runs
the clip through BEATs' front end (``ops/fbank.py``) and encoder
(``models/beats.py``, its attention through
``ops/rel_attention.gated_rel_attention``) and fuses its frames with the
CNN's before the BiGRU (``models/beats.BeatsFusion``, the DCASE Task 4
baseline's ``cat_tf``); the CRNN's own parts run as without it.
A configuration served by HTS-AT (``ModelConfig.htsat``) runs no CRNN:
its front end is torchlibrosa's, on K1's power-dB form, then
``models/htsat.HTSAT`` in the compute dtype, its window attention through
``ops/window_attention.window_attention``, then its token-semantic head.
``make_sharded_forward`` serves a batch over several devices, a replica
each. Under a ``torch.profiler`` profile a forward marks its parts as
spans (``utils/profiling.span``): ``bsed.serve.mel``, ``stem`` (folded
and fused branches), ``cnn`` (the conv blocks after the stem, or the
whole stack), ``bigru`` and ``head``, with BEATs ``fbank`` (the
decimation and the fbank), ``beats`` (the encoder) and ``fuse`` (the
alignment and ``cat_tf``), with HTS-AT ``htsat`` (bn0, the fold, the
four stages and the final LayerNorm; its head is ``head``); the
feature-pyramid encoder's forward is not split.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.models.beats import BEATs, BeatsFusion
from bsed_tpu_torch.models.cnn import CNN
from bsed_tpu_torch.models.crnn import compute_dtype, make_encoder
from bsed_tpu_torch.models.htsat import HTSAT
from bsed_tpu_torch.models.layers import ConvBlock, conv2d_nhwc
from bsed_tpu_torch.models.predictor import make_predictor_head
from bsed_tpu_torch.models.rnn import BidirectionalGRU, HoistedBiGRU
from bsed_tpu_torch.ops import mel_kernel, stem_epilogue, stem_kernel
from bsed_tpu_torch.ops.fbank import BeatsFbank
from bsed_tpu_torch.ops.folded_stem import bn_affine, build_folded_stem
from bsed_tpu_torch.ops.mel import PRECISIONS, MelFrontEnd
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.device import resolve_device
from bsed_tpu_torch.utils.profiling import span


class _RestCNN(CNN):
    """Blocks ``start``..N-1 of the CNN stack (the leading blocks are served
    by the folded stem); float32 output."""

    def __init__(self, cfg: Config, start: int = 1, dtype=None):
        m = cfg.model
        super().__init__(tuple(m.nb_filters),
                         tuple(tuple(p) for p in m.pooling), m.activation,
                         m.kernel_size, dtype=dtype,
                         n_in_channel=m.n_in_channel, start=start)


def group_pool_serves(cfg: Config, start: int) -> bool:
    """Whether each of blocks ``start``..N-1 can run as its conv and one
    call of K2's group-pool form: GLU or context gating, and
    ``stem_epilogue.group_form_ok`` for the block's G frequency rows,
    channels and pool."""
    m = cfg.model
    if m.activation not in ("glu", "cg"):
        return False
    g = cfg.audio.n_mels
    for _, pf in m.pooling[:start]:
        g //= pf
    for cout, (pt, pf) in zip(m.nb_filters[start:], m.pooling[start:]):
        if not stem_epilogue.group_form_ok(g, pt, pf, cout):
            return False
        g //= pf
    return True


@torch.no_grad()
def fold_conv_block(block: ConvBlock, dtype=None) -> Dict[str, torch.Tensor]:
    """K2's constants for one eval-mode GLU / CG ``ConvBlock``, folded in
    float32 from its running statistics: ``inv`` = γ·rsqrt(var + ε),
    ``c`` = (conv bias − mean)·inv + β, the gate's dense as ``w`` (in,
    out) in ``dtype`` (None: float32) and its bias ``b``; with the conv's
    ``weight`` in ``dtype``, channels-last."""
    dt = dtype or torch.float32
    bn, lin = block.bn, block.act.linear
    inv, c = bn_affine(bn, block.conv.bias.float(), bn.running_mean.float(),
                       bn.running_var.float(), bn.eps)
    return {"weight": block.conv.weight.to(dt).contiguous(
                memory_format=torch.channels_last),
            "inv": inv, "c": c, "w": lin.weight.t().to(dt).contiguous(),
            "b": lin.bias.float()}


class GroupPoolCNN:
    """Blocks ``start``..N-1 of an eval-mode ``_RestCNN`` in serving form:
    each block is its conv without bias (cuDNN, NHWC) and K2's group-pool
    form in eval form, which computes the BatchNorm, the gate and the
    block's (pt, pg) pool in one pass over the conv's output; for layouts
    ``group_pool_serves`` admits. With ``fused_epilogue`` that is K2's
    entry (``ops/stem_epilogue.stem_epilogue_fwd``, looked up at call
    time), else its plain version ``stem_epilogue_plain``. Float32
    output, as ``_RestCNN``'s."""

    def __init__(self, rest: _RestCNN, activation: str, dtype=None,
                 fused_epilogue: bool = True):
        self.dtype = dtype or torch.float32
        self.act = activation
        self.fused_epilogue = fused_epilogue
        self.blocks = [(fold_conv_block(blk, dtype), blk.conv.padding[0],
                        *blk.pooling) for blk in rest.blocks.values()]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for k, pad, pt, pg in self.blocks:
            h = conv2d_nhwc(x, k["weight"], padding=pad).contiguous()
            args = (h, k["inv"], k["c"], k["w"], k["b"], self.act, pt, None)
            if self.fused_epilogue:
                x = stem_epilogue.stem_epilogue_fwd(*args, 0, pg=pg)
            else:
                x = stem_epilogue.stem_epilogue_plain(*args, pg=pg)
        return x.float()


def _fold_divides(pooling, fold0: int = 8) -> bool:
    """True when every leading block's frequency pool divides the running
    fold, i.e. ``build_folded_stem`` can fold this layout."""
    f = fold0
    for _, pf in (tuple(p) for p in pooling):
        if f == 1:
            break
        if pf == 0 or f % pf != 0:
            return False
        f //= pf
    return True


def build_encoder(cfg: Config, enc_params: Dict, enc_stats: Dict, dev,
                  *, use_folded_stem: Optional[bool] = None,
                  use_fused_epilogue: Optional[bool] = None,
                  use_fused_stem: bool = False,
                  fuse: Optional[Callable] = None) -> Callable:
    """The eval-mode CRNN encoder on ``dev`` from the encoder's flax-layout
    trees: ``encode(log_mel (B, T, F, 1), emb=None) -> (B, T', 2H)``
    float32, the input in NHWC layout; with ``fuse`` (``BeatsFusion``;
    the folded and standard branches of the plain CRNN) the CNN's frames
    are fused with ``emb`` before the BiGRU. Shared by ``make_fast_forward`` and
    ``train.steps.make_predict_fn``; the options are
    ``make_fast_forward``'s (see there). Every branch runs the BiGRU
    hoisted (``HoistedBiGRU``, on K4); the feature-pyramid encoder (``use_fpn``,
    standard branch) runs its three, at T, T/2 and T/4 frames. The folded
    branch serves the blocks after the stem as ``GroupPoolCNN`` where
    ``group_pool_serves`` admits the layout, else as ``_RestCNN``."""
    m = cfg.model
    folded = (use_folded_stem is not False and not use_fused_stem
              and not m.use_fpn
              and m.kernel_size == 3
              and m.activation in ("glu", "cg", "relu", "leakyrelu")
              and cfg.audio.n_mels % 8 == 0
              and m.predictor_head != "crnn"
              and _fold_divides(m.pooling))
    fused = (use_fused_stem and not folded and not m.use_fpn
             and m.activation == "glu" and cfg.audio.n_mels == 128)
    if m.htsat is not None:
        raise ValueError("an HTS-AT configuration runs no CRNN encoder: "
                         "make_fast_forward serves it")
    if fuse is not None and (fused or m.use_fpn):
        raise ValueError("a BEATs fusion serves the folded or standard "
                         "CRNN, not the fused stem or the FPN encoder")
    if (fuse is None) != (m.beats is None):
        raise ValueError("a BEATs configuration's encoder takes its fusion "
                         "(make_fast_forward serves it from raw audio), "
                         "and only such a configuration's")

    def fused_with(h, emb):
        if fuse is None:
            return h
        with span("serve.fuse"):
            return fuse(h, emb)
    if not (folded or fused):
        encoder = make_encoder(m)
        weights.load_crnn(encoder, enc_params, enc_stats)
        encoder.to(dev).eval()
        if m.use_fpn:
            # the three pyramid BiGRUs (T, T/2, T/4), each hoisted
            bigrus = {n: HoistedBiGRU(getattr(encoder, n))
                      for n in ("rnn", "rnn_2", "rnn_4")}

            def encode(mel):               # CRNNFPN.forward, eval
                return encoder(mel, bigrus=bigrus)[0]
            return encode
        bigru = HoistedBiGRU(encoder.rnn)

        def encode(mel, emb=None):         # CRNN.forward, eval
            with span("serve.cnn"):
                h = encoder.cnn(mel).squeeze(2)
            h = fused_with(h, emb)
            with span("serve.bigru"):
                return bigru(h)
        return encode
    if folded:
        dtype = compute_dtype(m)
        if use_fused_epilogue is None:
            use_fused_epilogue = dev.type == "cuda"
        stem, start = build_folded_stem(
            enc_params["cnn"], enc_stats["cnn"], m.nb_filters,
            tuple(tuple(p) for p in m.pooling), activation=m.activation,
            n_mels=cfg.audio.n_mels, dtype=dtype,
            fused_epilogue=use_fused_epilogue, device=dev)
    else:
        dtype, start = None, 1        # float32, as bsed_tpu builds them
        fold = stem_kernel.fold_block0_params(
            enc_params["cnn"]["block0"], enc_stats["cnn"]["block0"],
            device=dev)

        def stem(mel):
            return stem_kernel.fused_stem_block(mel, fold)
    rest = _RestCNN(cfg, start=start, dtype=dtype)
    weights.load_cnn(rest, enc_params["cnn"], enc_stats["cnn"])
    rnn = BidirectionalGRU(m.nb_filters[-1], m.n_rnn_cell,
                           m.n_layers_rnn, m.dropout_recurrent,
                           dtype=dtype)
    weights.load_gru(rnn, enc_params["rnn"])
    rest.to(dev).eval()
    if folded and group_pool_serves(cfg, start):
        rest = GroupPoolCNN(rest, m.activation, dtype, use_fused_epilogue)
    bigru = HoistedBiGRU(rnn.to(dev))

    def encode(mel, emb=None):
        with span("serve.stem"):
            h = stem(mel)
        with span("serve.cnn"):
            h = rest(h).squeeze(2)
        h = fused_with(h, emb)
        with span("serve.bigru"):
            return bigru(h)
    return encode


class BeatsBranch:
    """BEATs' part of a served forward on ``dev``: ``fbank`` (the clip to
    its normalised fbank, float32), ``encoder`` (``models/beats.BEATs`` in
    ``dtype``, ``BEATs.cast``; eval mode, from ``params["beats"]``) and ``fuse`` (``BeatsFusion`` with
    ``params["encoder"]["cat_tf"]``)."""

    def __init__(self, cfg: Config, params: Dict, dev, dtype=None):
        bc = cfg.model.beats
        dtype = dtype or torch.float32
        self.fbank = BeatsFbank(bc, dev)
        self.encoder = BEATs(bc)
        weights.load_beats(self.encoder, params["beats"])
        self.encoder.to(dev).cast(dtype).eval()
        cat = params["encoder"]["cat_tf"]
        self.fuse = BeatsFusion(cat["kernel"], cat["bias"],
                                bc.num_mel_bins // bc.input_patch_size,
                                dtype, dev)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n_samples) float32 → (B, L, d) embeddings."""
        with span("serve.fbank"):
            fb = self.fbank(audio)
        with span("serve.beats"):
            return self.encoder(fb)


def build_predictor(cfg: Config, pred_params: Dict, dev,
                    pred_stats: Optional[Dict] = None) -> torch.nn.Module:
    """The eval-mode predictor head on ``dev`` from its flax-layout tree;
    the 'crnn' conv head also takes its statistics (``batch_stats
    ["predictor"]``), as ``bsed_tpu``'s serving threads them
    (serve.py:103-107)."""
    predictor = make_predictor_head(cfg)
    weights.load_predictor(predictor, pred_params, pred_stats)
    return predictor.to(dev).eval()


def make_htsat_forward(cfg: Config, params: Dict, batch_stats: Dict,
                       dev) -> Callable:
    """``make_fast_forward`` for ``cfg.model.htsat``: the front end in
    float32 at torchlibrosa's settings (K1's power-dB form, which writes
    the log-mel in one launch; a geometry outside its envelope raises
    ValueError), HTS-AT from ``params["htsat"]``
    and ``batch_stats["htsat"]`` (``utils/weights.load_htsat``) in the
    compute dtype, bn0 in float32; ``forward.htsat`` is the module, open
    to a caller's hooks."""
    model = HTSAT(cfg.model.htsat, cfg.audio.n_mels, cfg.nclass)
    weights.load_htsat(model, params["htsat"], batch_stats["htsat"])
    model.to(dev).cast(compute_dtype(cfg.model) or torch.float32).eval()
    fe = MelFrontEnd(cfg.audio, algorithm="block_kernel", device=dev,
                     torchlibrosa=True)

    @torch.inference_mode()
    def forward(audio):
        audio = torch.as_tensor(audio, dtype=torch.float32, device=dev)
        with span("serve.mel"):
            mel = fe(audio, log=True)
        with span("serve.htsat"):
            tokens = model(mel)
        with span("serve.head"):
            return model.head(tokens)

    forward.htsat = model
    return forward


def make_fast_forward(cfg: Config, params: Dict, batch_stats: Dict, *,
                      device="cuda", precision: str = "high",
                      mel_algorithm: Optional[str] = None,
                      use_folded_stem: Optional[bool] = None,
                      use_fused_epilogue: Optional[bool] = None,
                      use_fused_stem: bool = False) -> Callable:
    """Returns ``forward(audio (B, n_samples)) -> (strong (B, T', C),
    weak (B, C))`` on raw audio, float32 tensors on ``device``.

    Differs from ``bsed_tpu.serve.make_fast_forward`` in its signature:
    ``params``/``batch_stats`` are the flax-layout trees as numpy arrays
    (``utils/weights.py``) in place of ``TrainModules``, and the device is
    explicit. Each kernel below runs or gives way to its plain PyTorch
    version as ``kernels.launches_on`` decides, on every call.
    Every branch runs the BiGRU as ``bsed_tpu``'s module does, hoisted
    (``HoistedBiGRU``: one projection a layer, both recurrences in one
    call of K4).

    With ``cfg.model.beats`` the forward also runs ``BeatsBranch`` on the
    audio, in the compute dtype, and fuses its embeddings with the CNN's
    frames before the BiGRU (``params`` then holds ``beats`` and
    ``encoder.cat_tf``, ``utils/weights.py``); ``forward.beats`` is that
    ``BeatsBranch`` (None without BEATs), its ``encoder`` module open to
    a caller's hooks.

    With ``cfg.model.htsat`` it serves HTS-AT instead
    (``make_htsat_forward``): ``forward(audio) -> (framewise (B, frames,
    C), clipwise (B, C))``, ``params["htsat"]`` and
    ``batch_stats["htsat"]`` its state dict and bn0's statistics; the
    options after ``precision`` are the CRNN's, and any of them set
    raises ValueError.

    Auto choices (None) follow the JAX package with "on CUDA" for "on TPU":
    the mel kernel K1 runs when ``precision`` is 'high' or 'fast' and the
    audio geometry meets its constraints; the folded stem serves eligible
    topologies; its fused epilogue (kernel K2) is on by default on CUDA,
    for blocks 0-2 and, in K2's group-pool form, the blocks after them
    (``GroupPoolCNN``); ``use_fused_epilogue=False`` launches no K2:
    blocks 0-2 run the unfused chain, the blocks after them K2's plain
    version.

    ``use_fused_stem`` selects the fused block-0 stem for the non-FPN GLU
    CRNN on 128 mels (other encoders fall through to the standard branch,
    as in the JAX package): block 0 is kernel K5
    (``stem_kernel.fused_stem_block``). That branch runs blocks 1-6 and the BiGRU in
    float32 whatever ``compute_dtype`` says, as ``bsed_tpu`` builds them
    without a dtype there.
    """
    dev = resolve_device(device)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision}")
    if cfg.model.htsat is not None:
        if (mel_algorithm, use_folded_stem, use_fused_epilogue,
                use_fused_stem) != (None, None, None, False):
            raise ValueError("HTS-AT runs its own torchlibrosa front end "
                             "and no CRNN: mel_algorithm, use_folded_stem, "
                             "use_fused_epilogue and use_fused_stem are the "
                             "CRNN's options")
        return make_htsat_forward(cfg, params, batch_stats, dev)
    a = cfg.audio
    if mel_algorithm is None:
        mel_algorithm = (
            "block_kernel"
            if (precision in ("high", "fast") and dev.type == "cuda"
                and mel_kernel.supports(a.n_window, a.hop_size, a.n_mels))
            else "dense")
    beats = (BeatsBranch(cfg, params, dev, compute_dtype(cfg.model))
             if cfg.model.beats is not None else None)
    encode = build_encoder(cfg, params["encoder"], batch_stats["encoder"],
                           dev, use_folded_stem=use_folded_stem,
                           use_fused_epilogue=use_fused_epilogue,
                           use_fused_stem=use_fused_stem,
                           fuse=beats and beats.fuse)
    predictor = build_predictor(cfg, params["predictor"], dev,
                                batch_stats.get("predictor"))
    fe = MelFrontEnd(a, algorithm=mel_algorithm, device=dev)

    @torch.inference_mode()
    def forward(audio):
        audio = torch.as_tensor(audio, dtype=torch.float32, device=dev)
        with span("serve.mel"):
            mel = fe(audio, log=True)[..., None]
        h = encode(mel) if beats is None else encode(mel, beats(audio))
        with span("serve.head"):
            return predictor(h)

    forward.beats = beats
    return forward


def make_sharded_forward(cfg: Config, params: Dict, batch_stats: Dict,
                         devices: Sequence, precision: str = "high",
                         **kw) -> Callable:
    """Data-parallel serving over ``devices`` from one process: the port of
    ``bsed_tpu.serve.make_sharded_forward`` (a ``shard_map`` of the fused
    program over a data mesh). One replica of ``make_fast_forward`` is
    built a listed device (a device listed twice gets two replicas, so one
    card can run the path); ``forward(audio (B, n_samples))`` splits the
    batch by rows into ``len(devices)`` equal parts, runs each on its
    replica, and concatenates the outputs in order on the first device.
    Clips are independent, so there is no collective: each replica runs
    the whole program, K1, K2 and K4 included. ``B`` must divide by the
    number of replicas (pad a ragged tail, as the CLI's ``predict``
    does); ``kw`` goes to every ``make_fast_forward``."""
    devices = [resolve_device(d) for d in devices]
    replicas = [make_fast_forward(cfg, params, batch_stats, device=d,
                                  precision=precision, **kw)
                for d in devices]

    def forward(audio):
        n = len(replicas)
        if audio.shape[0] % n:
            raise ValueError(f"a batch of {audio.shape[0]} rows does not "
                             f"divide over {n} replicas")
        parts = torch.as_tensor(audio, dtype=torch.float32).chunk(n)
        outs = [fwd(part.to(d, non_blocking=True))
                for fwd, part, d in zip(replicas, parts, devices)]
        return tuple(torch.cat([o[i].to(devices[0]) for o in outs])
                     for i in range(2))

    return forward


def predict_long_recording(forward: Callable, audio, cfg: Config,
                           batch_size: int = 32, hop_seconds: float = None):
    """Sound-event inference over an arbitrarily long recording: the
    recording is cut into clip windows (optionally overlapping), batched
    through ``forward``, and the frame posteriors are re-assembled on a
    global timeline (overlaps averaged). Returns (strong (T_total, C),
    frame_seconds)."""
    sr = cfg.audio.sr
    clip = cfg.audio.n_samples
    hop = int((hop_seconds or cfg.audio.max_len_seconds) * sr)
    audio = np.asarray(audio, np.float32)
    if len(audio) < clip:
        audio = np.pad(audio, (0, clip - len(audio)))
    starts = list(range(0, max(len(audio) - clip, 0) + 1, hop))
    if starts[-1] + clip < len(audio):
        starts.append(len(audio) - clip)
    windows = np.stack([audio[s:s + clip] for s in starts])

    frames_per_clip = cfg.n_frames
    sec_per_frame = cfg.model.pooling_time_ratio / (sr / cfg.audio.hop_size)
    total_frames = int(np.ceil(
        (starts[-1] / sr) / sec_per_frame)) + frames_per_clip
    acc = np.zeros((total_frames, cfg.nclass), np.float64)
    cnt = np.zeros((total_frames, 1), np.float64)

    for i in range(0, len(windows), batch_size):
        chunk = windows[i:i + batch_size]
        pad = 0
        if len(chunk) < batch_size and len(windows) > batch_size:
            pad = batch_size - len(chunk)
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        strong, _ = forward(chunk)
        strong = strong.cpu().numpy() if torch.is_tensor(strong) \
            else np.asarray(strong)
        if pad:
            strong = strong[:-pad]
        for j, s in enumerate(starts[i:i + len(strong)]):
            f0 = int(round((s / sr) / sec_per_frame))
            acc[f0:f0 + frames_per_clip] += strong[j]
            cnt[f0:f0 + frames_per_clip] += 1.0
    covered = cnt[:, 0] > 0
    last = int(np.nonzero(covered)[0][-1]) + 1
    acc, cnt, covered = acc[:last], cnt[:last], covered[:last]
    acc[covered] /= cnt[covered]
    # frame index == global time index: interior frames no window covered
    # (hop_seconds > clip length) stay ZERO posteriors
    return acc.astype(np.float32), sec_per_frame
