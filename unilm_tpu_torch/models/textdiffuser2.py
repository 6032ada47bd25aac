"""TextDiffuser-2: layout planning by a language model, then
text-rendering diffusion (port of unilm_tpu/models/textdiffuser2.py).

- M1, `LayoutPlannerLM`: a compact causal LM on the core `Decoder`
  (pre-norm, sub-LN, swiglu, xPos, no learned positions) over an explicit
  layout vocabulary (`LayoutVocab`: structure ids, the caption alphabet,
  coordinate bins l/t/r/b on a 128 x 128 canvas), with a key-padding mask
  in train mode only and the tied output `x @ embed.T`. `prefill` /
  `decode_step` run over a `cache_size` cache (the core's paged pools), so
  planning is one `runtime/generate.greedy_generate` call
  (`make_planner_fns`). On a CUDA tensor the attention takes the flash
  kernels' dispatch (#5 where `onepass_applies`, as JAX's selector).
- M2: models/textdiffuser.py's character-mask UNet; the planned boxes are
  rasterised by `render_char_mask` and drive DDIM (`TextDiffuser2Pipeline`).
- The plain-text ``keyword l,t,r,b`` grammar (`parse_layout_text` /
  `format_layout_text`), `layout_to_pixel_boxes`, `planner_example` and
  `planner_loss` are copies of JAX's.

Greedy planning gives JAX's tokens; sampled planning draws from a
`torch.Generator` (not JAX's key), so only its validity can be compared.
"""

from __future__ import annotations

import dataclasses
import re
import string
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import init_weights_
from unilm_tpu_torch.core.transformer import Decoder
from unilm_tpu_torch.models.textdiffuser import (TextDiffuserUNet,
                                                 ddim_sample,
                                                 render_char_mask)
from unilm_tpu_torch.runtime.device import resolve_device

# The reference plans on a fixed 128x128 canvas
# (inference_textdiffuser2_t2i_full.py:510 "The size of the image is 128x128").
CANVAS = 128

# M2's character alphabet (inference_textdiffuser2_t2i_full.py:24).
ALPHABET = (
    string.digits + string.ascii_lowercase + string.ascii_uppercase
    + string.punctuation + " "
)

Box = Tuple[int, int, int, int]
Layout = List[Tuple[str, Box]]


# --------------------------------------------------------------------------- #
# Layout vocabulary: caption/keyword characters + coordinate bins + structure
# --------------------------------------------------------------------------- #

class LayoutVocab:
    """Token ids for the planner LM.

    0=pad 1=bos 2=eos 3=sep(line break) 4=box(start-of-coords), then the
    95-char alphabet, then l0..l127, t0..t127, r0..r127, b0..b127 — the same
    coordinate-token scheme M2's extended CLIP tokenizer uses
    (inference_textdiffuser2_t2i_full.py:571 ``'l'+str(l), 't'+str(t), ...``).
    """

    PAD, BOS, EOS, SEP, BOX = 0, 1, 2, 3, 4

    def __init__(self, canvas: int = CANVAS):
        self.canvas = canvas
        self.char_base = 5
        self.c2i = {c: self.char_base + i for i, c in enumerate(ALPHABET)}
        self.i2c = {v: k for k, v in self.c2i.items()}
        self.coord_base = self.char_base + len(ALPHABET)
        # coordinate axes in the reference's l,t,r,b order
        self.axes = "ltrb"
        self.size = self.coord_base + 4 * canvas

    def coord_token(self, axis: int, v: int) -> int:
        v = int(np.clip(v, 0, self.canvas - 1))
        return self.coord_base + axis * self.canvas + v

    def decode_coord(self, tok: int) -> Optional[Tuple[int, int]]:
        if tok < self.coord_base or tok >= self.size:
            return None
        axis, v = divmod(tok - self.coord_base, self.canvas)
        return axis, v

    def encode_text(self, text: str) -> List[int]:
        return [self.c2i[c] for c in text if c in self.c2i]

    def encode_prompt(self, caption: str, max_len: int) -> np.ndarray:
        """[max_len] int32, BOS + caption chars + BOX marker, left-padded is
        NOT used — planner prompts are right-padded with PAD and the decode
        starts from the true length (static-shape greedy_generate)."""
        ids = [self.BOS] + self.encode_text(caption)[: max_len - 2] + [self.BOX]
        ids = ids + [self.PAD] * (max_len - len(ids))
        return np.asarray(ids, np.int32)

    def encode_layout(self, layout: Layout) -> List[int]:
        """keyword chars + l/t/r/b coord tokens + SEP per line, EOS last."""
        ids: List[int] = []
        for word, (l, t, r, b) in layout:
            ids += self.encode_text(word)
            ids += [self.coord_token(a, v) for a, v in enumerate((l, t, r, b))]
            ids.append(self.SEP)
        ids.append(self.EOS)
        return ids

    def decode_layout(self, ids: Sequence[int]) -> Layout:
        """Inverse of encode_layout; tolerant of malformed model output —
        lines missing any of the four coordinates are dropped, mirroring the
        reference's skip-on-parse-failure (t2i_full.py:560-566)."""
        layout: Layout = []
        word: List[str] = []
        coords: dict = {}
        for tok in ids:
            tok = int(tok)
            if tok == self.EOS:
                break
            if tok == self.SEP:
                if len(coords) == 4 and word:
                    layout.append(
                        ("".join(word), tuple(coords[a] for a in range(4))))
                word, coords = [], {}
                continue
            c = self.decode_coord(tok)
            if c is not None:
                coords[c[0]] = c[1]
            elif tok in self.i2c:
                word.append(self.i2c[tok])
        return layout


# --------------------------------------------------------------------------- #
# Plain-text grammar (the reference M1's output format)
# --------------------------------------------------------------------------- #

_LINE_RE = re.compile(r"^(.*?)\s+(\d+),(\d+),(\d+),(\d+)\s*$")


def parse_layout_text(text: str, canvas: int = CANVAS) -> Layout:
    """Parse ``keyword l,t,r,b`` lines (t2i_full.py:559-571): splits each
    line on whitespace, last item is the comma-separated box; skips empty
    lines and the reference's '###'/'.com' junk filters."""
    layout: Layout = []
    for line in text.splitlines():
        line = line.strip()
        if not line or "###" in line or ".com" in line:
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        word = m.group(1).strip()
        l, t, r, b = (int(np.clip(int(m.group(i)), 0, canvas)) for i in range(2, 6))
        if word:
            layout.append((word, (l, t, r, b)))
    return layout


def format_layout_text(layout: Layout) -> str:
    return "\n".join(f"{w} {l},{t},{r},{b}" for w, (l, t, r, b) in layout)


def layout_to_pixel_boxes(
    layout: Layout, img_size: int, canvas: int = CANVAS
) -> List[Tuple[str, Box]]:
    """Scale canvas-space boxes to image pixels for render_char_mask."""
    s = img_size / canvas
    out = []
    for word, (l, t, r, b) in layout:
        x0, y0 = int(l * s), int(t * s)
        x1, y1 = max(int(r * s), x0 + 1), max(int(b * s), y0 + 1)
        out.append((word, (x0, y0, min(x1, img_size), min(y1, img_size))))
    return out


# --------------------------------------------------------------------------- #
# M1: the layout-planner LM
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class LayoutPlannerConfig:
    vocab_size: int = LayoutVocab().size
    embed_dim: int = 256
    ffn_dim: int = 1024
    num_layers: int = 4
    num_heads: int = 4
    max_positions: int = 512
    dropout: float = 0.0
    dtype: Any = torch.float32
    use_flash: bool = True

    def core(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size,
            embed_dim=self.embed_dim,
            ffn_dim=self.ffn_dim,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            dropout=self.dropout,
            max_positions=self.max_positions,
            normalize_before=True,
            subln=True,
            activation="swiglu",
            xpos_rel_pos=True,
            learned_pos=False,
            dtype=self.dtype,
            use_flash=self.use_flash,
        )


class LayoutPlannerLM(nn.Module):
    """Causal LM over the layout vocabulary: caption characters -> layout
    tokens (BOS caption BOX -> keyword coordinates SEP ... EOS).
    Parameters: `embed` (float32, used in cfg.dtype; tied to the output)
    and `decoder`."""

    def __init__(self, cfg: LayoutPlannerConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim, device=dev)
        self.embed.init_std = cfg.embed_dim ** -0.5  # flax Embed's default
        self.decoder = Decoder(cfg.core(), device=dev)

    def init_weights(self, generator: torch.Generator) -> "LayoutPlannerLM":
        init_weights_(self, generator)
        return self

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.embed.weight.to(x.dtype))

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Train mode: [B, T] -> [B, T, V] logits, PAD keys masked.
        `generator`: the dropout draws of a training forward."""
        x = self.embed(tokens).to(self.cfg.dtype)
        x = self.decoder(x, self_key_padding_mask=tokens != LayoutVocab.PAD,
                         generator=generator)
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_size: int):
        """(logits [B, T, V], cache) of a prompt in a `cache_size` cache."""
        x = self.embed(tokens).to(self.cfg.dtype)
        x, cache = self.decoder(x, mode="prefill", cache_size=cache_size)
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Dict,
                    cache_size: int):
        """(logits, cache) of the next token(s) [B, 1]; the cache's pools
        are written in place."""
        x = self.embed(tokens).to(self.cfg.dtype)
        x, cache = self.decoder(x, mode="decode", cache_size=cache_size,
                                cache=cache)
        return self._logits(x), cache


def make_planner_fns(model: LayoutPlannerLM, cache_size: int):
    """(prefill, step) pair for runtime/generate.py's decoding loops."""

    def prefill(tokens, aux):
        return model.prefill(tokens, cache_size)

    def step(tokens, cache, aux):
        return model.decode_step(tokens, cache, cache_size)

    return prefill, step


def planner_example(
    vocab: LayoutVocab, caption: str, layout: Layout, max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens [max_len], loss_mask [max_len]) — next-token CE is masked to
    the layout segment only (the caption is conditioning, not target)."""
    prompt = [vocab.BOS] + vocab.encode_text(caption) + [vocab.BOX]
    target = vocab.encode_layout(layout)
    ids = (prompt + target)[:max_len]
    mask = ([0.0] * len(prompt) + [1.0] * len(target))[:max_len]
    pad = max_len - len(ids)
    tokens = np.asarray(ids + [vocab.PAD] * pad, np.int32)
    # mask applies to the PREDICTION of position i (i.e. logits[i-1])
    loss_mask = np.asarray(mask + [0.0] * pad, np.float32)
    return tokens, loss_mask


def planner_loss(model: LayoutPlannerLM, tokens: torch.Tensor,
                 loss_mask: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Masked next-token cross-entropy."""
    logits = model(tokens, generator)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    m = loss_mask[:, 1:]
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


# --------------------------------------------------------------------------- #
# Two-stage pipeline: plan (M1) -> rasterize -> diffuse (M2)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class TextDiffuser2Pipeline:
    """Layout planning and char-mask DDIM rendering, the full t2i path
    (M2 is models/textdiffuser.py's standalone UNet). Runs on the
    planner's device; the UNet must be on the same one."""

    planner: LayoutPlannerLM
    unet: TextDiffuserUNet
    vocab: LayoutVocab = dataclasses.field(default_factory=LayoutVocab)
    prompt_len: int = 96
    max_new_tokens: int = 160

    def plan_tokens(self, caption: str,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 0.7, sample: bool = False
                    ) -> Tuple[torch.Tensor, int]:
        """(tokens [1, n_valid + max_new_tokens], n_valid): greedy, or
        sampled at `temperature` from `generator`."""
        from unilm_tpu_torch.runtime.generate import (GenerationConfig,
                                                      greedy_generate)

        dev = self.planner.embed.weight.device
        prompt = self.vocab.encode_prompt(caption, self.prompt_len)
        n_valid = int(np.sum(prompt != self.vocab.PAD))
        prompt = torch.from_numpy(prompt[:n_valid]).long().to(dev)[None]
        prefill, step = make_planner_fns(self.planner,
                                         n_valid + self.max_new_tokens)
        cfg = GenerationConfig(
            max_new_tokens=self.max_new_tokens, eos=self.vocab.EOS,
            pad=self.vocab.PAD, sampling=sample,
            temperature=temperature if sample else 1.0)
        tokens, _ = greedy_generate(cfg, prefill, step, prompt,
                                    generator=generator)
        return tokens, n_valid

    def plan(self, caption: str,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.7, sample: bool = False) -> Layout:
        """M1: caption -> layout (the reference samples at temperature
        0.7; greedy is the deterministic mode)."""
        tokens, n_valid = self.plan_tokens(caption, generator, temperature,
                                           sample)
        return self.vocab.decode_layout(tokens[0, n_valid:].tolist())

    def render(self, layout: Layout,
               generator: Optional[torch.Generator] = None, steps: int = 20,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """M2: layout -> image [1, H, W, C] by char-mask conditioned DDIM
        (z drawn from `generator` unless given)."""
        img_size = self.unet.cfg.img_size
        boxes = layout_to_pixel_boxes(layout, img_size)
        dev = self.unet.out.weight.device
        mask = torch.from_numpy(render_char_mask(boxes, img_size))[None]
        return ddim_sample(self.unet, mask.to(dev), generator, steps=steps,
                           z=z)

    def __call__(self, caption: str,
                 generator: Optional[torch.Generator] = None,
                 steps: int = 20, sample_layout: bool = False
                 ) -> Tuple[torch.Tensor, Layout]:
        layout = self.plan(caption, generator, sample=sample_layout)
        return self.render(layout, generator, steps=steps), layout
