"""GIT model assembly: ViT encoder + unified decoder, the counterpart of
`gitax.models.git`.

`GitModel` is an nn.Module whose state dict uses the reference names
(`image_encoder.*`, `textual.*`), so `gitax.ckpt.export_git_state_dict`
of a gitax tree and this module's `state_dict()` agree key for key (see
`gitax_torch.ckpt`).  Ported: single-image encoding at any grid of whole
patches (the MinMax high-res inputs included), video clips (frames
encoded one by one, offset by their temporal embeddings and concatenated
or averaged), memory with or without text context (`memory_valid`
masks the context's padding), and generation with or without a question
prefix: beam search, sampled or not, with the repetition penalty and
`num_return_sequences`, the encoder and the prefill taking the
fused-attention kernel by gitax's auto rule and the int8 head optionally
taking the fused vocab-head kernel; greedy; and trie-constrained greedy.
Training: `trainable_` and `forward_logits`, the teacher-forced logits
under autograd on the plain attention (gitax git.py:145-183), on one card
or, sharded by `parallel.mesh.shard_params`, on a (data, model) mesh.
Generation also runs on a model sharded for tensor parallelism
(`parallel.mesh.shard_for_inference`): every rank of a model group runs
the same search on the same full logits (the all-reduce gives each rank
the same sums); a sampled search first gives every rank's generator the
state of the group's rank 0 (`share_generator`), so that each rank draws
the same noise, as gitax's SPMD search draws one key that every shard
sees.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..decode import device_loop
from ..decode.beam import BeamSearchConfig, beam_search
from ..decode.greedy import greedy_search
from ..decode.trie import trie_greedy_search
from ..ops.flash_attention import auto_flash
from ..ops.vocab_topk import TILE
from ..parallel import comm
from ..runtime import profiling
from . import textual as T
from .config import GitConfig
from .nn import empty_param
from .vit import VisualTransformer, vit_forward


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when the caller names
    one, else the CUDA card.  Without a card that raises; there is no
    silent move to the CPU (pass device='cpu' for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless the caller "
                           "passes device='cpu'")
    return torch.device("cuda")


def quantized_modules(model):
    """The names of a model's int8 modules: `Linear`s, the head and the
    ViT's fused qkv (`quantized`)."""
    return [name for name, m in model.named_modules() if getattr(m, "quantized", False)]


class GitModel(nn.Module):
    """GIT: parameters are created frozen (requires_grad=False, the
    inference default; `trainable_` thaws them) on `device` (default: the
    CUDA card, see `resolve_device`) in `dtype` (random values until
    `init_params` or `ckpt.params_from_gitax` fills them).  A video config
    (num_image_with_embedding = F > 0) adds `img_temperal_embedding`, F
    parameters [1, 1, Dv]: the reference's key and spelling, as gitax
    exports its [F, Dv] `img_temporal_embedding`."""

    def __init__(self, cfg: GitConfig, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.pooling_images not in (None, "avg"):
            raise ValueError("pooling_images {!r}: None or 'avg'".format(cfg.pooling_images))
        device = resolve_device(device)
        self.cfg = cfg
        self.image_encoder = VisualTransformer(cfg.encoder, device, dtype)
        self.textual = T.TextualHead(cfg, device, dtype)
        if cfg.num_image_with_embedding:
            self.img_temperal_embedding = nn.ParameterList(
                empty_param((1, 1, cfg.visual_feature_size), device, dtype)
                for _ in range(cfg.num_image_with_embedding)
            )
        # decode steps run through this model (beam iterations summed over
        # calls); read by chip_smoke.py to match kernel launches
        self.decode_step_calls = 0
        # the parallel.mesh.Mesh of a sharded model, else None
        self.mesh = None

    def init_params(self, generator: torch.Generator):
        """Random weights with gitax's shapes and scales, from a CPU
        generator."""
        self.image_encoder.init_params(generator)
        self.textual.init_params(generator)
        if self.cfg.num_image_with_embedding:
            with torch.no_grad():
                for p in self.img_temperal_embedding:
                    p.zero_()  # gitax initialises them to zeros
        return self

    def trainable_(self, flag: bool = True):
        """Make every floating parameter trainable (flag=True) or frozen.
        Raises on a model with an int8 `Linear`, head or fused qkv
        (`quantized`): int8, weight-only or w8a8, is an inference format,
        as in gitax.  The tied head is one Parameter shared by
        `textual.embedding.words` and `textual.output`, so the gradients of
        the embedding and of the head sum into it, as into gitax's one
        `embedding.words` leaf."""
        if flag:
            int8 = quantized_modules(self)
            if int8:
                raise ValueError("int8 Linears cannot train (weight-only int8 and w8a8 are "
                                 "inference formats): {}".format(", ".join(int8)))
        for p in self.parameters():
            if p.is_floating_point():
                p.requires_grad_(flag)
        return self

    # -- encoder ---------------------------------------------------------
    def encode_images(self, images, dtype=torch.float32, fast=None, flash=None, remat=False):
        """images [B, H, W, 3] (one image per element) or [B, F, H, W, 3]
        (video frames) -> tokens.  Frames are encoded as one batch of B*F
        images, each offset by its temporal embedding, then concatenated on
        the token axis ([B, F*S, Dv]) or, with pooling_images='avg',
        averaged ([B, S, Dv]) (gitax git.py:56-90).  Frames beyond
        num_image_with_embedding are dropped, as the reference's zip does.
        flash and remat: `vit_forward`'s (flash None: auto).

        On a card in inference (grad off), without remat and with no model
        group on the encoder, the body is replayed from a CUDA graph, one a
        batch shape (`decode.device_loop.encode`, keyed also by the
        activation dtype, fast and flash as resolved, for the encoder's
        weights where they lie; a bounded cache, whose misses past its
        bound run eagerly), in place of some 1,400 eager launches for
        ViT-L; it returns a new tensor all the same.  Every other call
        (the CPU, training, a tensor-parallel encoder) runs the body
        eagerly."""
        if images.dim() not in (4, 5):
            raise ValueError("images must be [B, H, W, 3] or [B, F, H, W, 3], got {}".format(
                tuple(images.shape)))
        if (not images.is_cuda or remat or torch.is_grad_enabled()
                or self.image_encoder.tp_group is not None):
            return self._encode(images, dtype, fast, flash, remat)
        enc = self.image_encoder.cfg
        fast = enc.fast_softmax if fast is None else bool(fast)
        if flash is None:
            p = enc.patch_size
            flash = auto_flash((images.shape[-3] // p) * (images.shape[-2] // p) + 1, dtype,
                               images.device)
        flash = bool(flash)
        return device_loop.encode(self, (dtype, fast, flash), images,
                                  lambda x: self._encode(x, dtype, fast, flash))

    def _encode(self, images, dtype, fast, flash, remat=False):
        """`encode_images`' body, eager."""
        if images.dim() == 4:
            return vit_forward(self.image_encoder, images, dtype, fast=fast, flash=flash,
                               remat=remat)
        b, f = images.shape[:2]
        n_emb = self.cfg.num_image_with_embedding
        if n_emb:
            f = min(f, n_emb)
            images = images[:, :f]
        feats = vit_forward(self.image_encoder, images.reshape((b * f,) + images.shape[2:]),
                            dtype, fast=fast, flash=flash, remat=remat)
        feats = feats.reshape(b, f, feats.shape[1], feats.shape[2])
        if n_emb:
            emb = torch.cat([self.img_temperal_embedding[i].reshape(1, -1) for i in range(f)])
            feats = feats + emb.to(feats.dtype)[None, :, None, :]
        if self.cfg.pooling_images == "avg":
            return feats.mean(dim=1)
        return feats.reshape(b, f * feats.shape[2], feats.shape[3])

    def append_text_context(self, visual, context_tokens, context_lengths,
                            dtype=torch.float32):
        """Concatenate embedded text context(s) onto the raw visual
        features, with a validity mask (reference decoder.py:859-871, gitax
        git.py:92-127): each context goes through the decoder's word and
        positional embedding, positions restarting at 0, before the visual
        projection, which needs visual_feature_size == hidden_size.

        context_tokens [B, Tc] or a list of such; context_lengths [B] per
        context.  Returns (memory [B, M + sum(Tc), D], memory_valid
        [B, M + sum(Tc)] bool)."""
        if self.cfg.visual_feature_size != self.cfg.hidden_size:
            raise ValueError("text context needs visual_feature_size == hidden_size ({} != {}), "
                             "as in the reference (decoder.py:863-870)".format(
                                 self.cfg.visual_feature_size, self.cfg.hidden_size))
        if not isinstance(context_tokens, (list, tuple)):
            context_tokens, context_lengths = [context_tokens], [context_lengths]
        b, dev = visual.shape[0], visual.device
        parts = [visual.to(dtype)]
        valids = [torch.ones((b, visual.shape[1]), dtype=torch.bool, device=dev)]
        for tokens, lengths in zip(context_tokens, context_lengths):
            parts.append(T.embed_captions(self.textual, tokens, self.cfg).to(dtype))
            valids.append(torch.arange(tokens.shape[1], device=dev)[None, :]
                          < lengths.to(dev)[:, None])
        return torch.cat(parts, 1), torch.cat(valids, 1)

    def build_memory(self, images, context_tokens=None, context_lengths=None,
                     dtype=torch.float32, fast=None, flash=None, remat=False):
        """Encode images and, given text context, append it (gitax
        git.py:129-142).  Returns (memory, memory_valid or None).  The
        encoder is the `model.encode` device span: its `tokens` the
        memory's (F x S for a clip of F frames), `frames` F (1 for an
        image) and `images` the encoder's, B x F."""
        with profiling.span("model.encode", device=images.is_cuda) as s:
            visual = self.encode_images(images, dtype, fast=fast, flash=flash, remat=remat)
            frames = images.shape[1] if images.dim() == 5 else 1
            if self.cfg.num_image_with_embedding:
                frames = min(frames, self.cfg.num_image_with_embedding)
            s.set(tokens=visual.shape[1], frames=frames, images=images.shape[0] * frames)
        if context_tokens is None:
            return visual, None
        return self.append_text_context(visual, context_tokens, context_lengths, dtype)

    # -- training forward --------------------------------------------------
    def forward_logits(self, images, caption_tokens, memory_valid=None, bi_valid_mask=None,
                       context_tokens=None, context_lengths=None, dtype=torch.float32,
                       fast=None, remat=False):
        """Teacher-forced caption logits [B, T, vocab] (reference
        decoder.py:926-932, gitax git.py:145-183), with grad enabled: the
        training path.  images [B, H, W, 3] or clips [B, F, H, W, 3];
        optional text context appended to the memory, or memory_valid
        [B, M], not both; bi_valid_mask [B, T] opens full attention to the
        marked caption positions.  The attention is the plain one on both
        towers (flash=False: the kernels have no backward), as gitax's is
        XLA's.  fast=True keeps the score math in the activation dtype in
        both towers (None leaves the encoder to its config); remat: the
        encoder's per-block checkpoint (`vit_forward`).  On a model sharded
        for tensor parallelism the same logits come out on every rank of
        its model group (the tied head is replicated)."""
        visual, ctx_valid = self.build_memory(images, context_tokens, context_lengths, dtype,
                                              fast=fast, flash=False, remat=remat)
        if ctx_valid is not None:
            if memory_valid is not None:
                raise ValueError("pass text context or memory_valid, not both")
            memory_valid = ctx_valid
        return T.textual_forward(self.textual, visual, caption_tokens, self.cfg,
                                 memory_valid=memory_valid, bi_valid_mask=bi_valid_mask,
                                 dtype=dtype, fast=bool(fast))

    # -- decode glue -------------------------------------------------------
    def prefill(self, visual_features, prefix_tokens, max_text_len,
                memory_valid=None, dtype=torch.float32, fast=False,
                kernel_memory=False, flash=None):
        return T.prefill(self.textual, visual_features, prefix_tokens, self.cfg,
                         max_text_len, memory_valid=memory_valid, dtype=dtype,
                         fast=fast, kernel_memory=kernel_memory, flash=flash)

    def decode_step(self, tokens, cache, dtype=torch.float32, kernel=False,
                    vocab_kernel=False, graph=False):
        self.decode_step_calls += 1
        return T.decode_step(self.textual, tokens, cache, self.cfg, dtype=dtype,
                             kernel=kernel, vocab_kernel=vocab_kernel, graph=graph)

    def vocab_kernel_applies(self, beam: BeamSearchConfig) -> bool:
        """gitax's gate of `vocab_kernel` (git.py:321-333): no sampling, no
        repetition penalty, the int8 head, and at least max(C, 4) vocab
        blocks, so that the prefilter's blocks cover the C candidates."""
        nblk = (self.cfg.vocab_size + TILE - 1) // TILE
        return (not beam.do_sample and beam.repetition_penalty == 1.0
                and self.textual.output.quantized
                and nblk >= max(beam.per_node_beam_size * beam.num_beams, 4))

    # -- generation --------------------------------------------------------
    @torch.inference_mode()
    def generate(self, images, prefix_tokens=None, beam: Optional[BeamSearchConfig] = None,
                 memory_valid=None, dtype=torch.float32, sos_id=101, mode="beam",
                 max_steps=None, num_return_sequences=1, rng=None, trie=None,
                 context_tokens=None, context_lengths=None, fast_prefill=False,
                 decode_kernel=False, flash=None, vocab_kernel=False, eager_loop=False):
        """Caption generation (reference decoder.py:977-1011) by beam
        search, greedy search (mode='greedy') or trie-constrained greedy
        search (mode='trie', over `trie`, a `decode.trie.TokenTrie`).

        prefix_tokens [B, Tp] defaults to [CLS]; an explicit prefix is
        stripped from the output.  With num_keep_best == 1 the keep axis
        is squeezed.  Text context (context_tokens, context_lengths, see
        `append_text_context`) is appended to the memory with its validity
        mask; memory_valid [B, M] bool marks the image tokens to attend
        to; not both.  num_return_sequences R > 1 repeats each input R
        times on the batch axis (decoder.py:1093-1096): outputs stay flat
        [B*R, ...].  rng: the torch.Generator of a sampling search
        (beam.do_sample), on the images' device.  decode_kernel: False
        (the plain decode path), True (the decode-attention kernel path)
        or 'int8' (the kernel path with int8 memory K/V).  flash: the encoder's and the prefill's
        fused-attention switch; None, gitax's only setting, applies the
        auto rule to each.  vocab_kernel=True runs the int8 head of every
        beam step through the fused vocab-head kernel and the search on its
        block statistics; with gitax's gates (`vocab_kernel_applies`) and,
        where they fail, the plain head, as gitax does.  images: [B, H, W,
        3] or video [B, F, H, W, 3].  Returns (sequences, logprobs).

        Greedy and trie (gitax git.py:346-370) prefill a max_steps buffer
        (default 40), prefix included, with the exact prefill and step on
        the plain attention path over a cache not tiled for beams; the
        beam's `beam` settings do not apply.  decode_kernel, vocab_kernel
        and fast_prefill raise there: gitax ignores them in these modes,
        and the port does not ignore a kernel switch silently.

        On a model sharded over a model group of m > 1 ranks, every rank
        of the group calls this with the same inputs; a sampled search
        there first sets every rank's `rng` to the state of the group's
        rank 0 (one broadcast a call, `share_generator`), so that the
        ranks draw the same noise whatever their callers seeded.

        The search's loop, gitax's device-side `while_loop`: on a CUDA
        device every mode runs one captured step replayed under a
        predicate the card computes (`decode.device_loop`), so this
        returns once the work is enqueued, before the search ends; the
        sequences come back as new tensors (the graph's buffers are not
        handed out).  On a model group of m > 1 that holds when the
        group is NCCL's (one card a rank): the step's all-reduces, over
        the mesh's graph group, are captured with it, and every rank of
        the group captures and replays the same step at the same call
        (see `_search_run`).  The encoder and the prefill stay eager, on
        the model group.  The eager loop, one host
        read a step, runs CPU tensors and gloo model groups (ranks on the
        CPU or sharing one card: a gloo all-reduce is a host round trip,
        which a graph cannot capture); eager_loop=True runs it on the
        card too, the reference the graph is held against (tests and
        chip_smoke.py pass it; the CLI, the engine and the server do
        not)."""
        if mode not in ("beam", "greedy", "trie"):
            raise ValueError("generate mode {!r}: 'beam', 'greedy' or 'trie'".format(mode))
        if mode == "beam" and beam is not None and beam.do_sample and rng is not None \
                and self.textual.tp_group is not None:
            share_generator(rng, self.mesh)
        if mode != "beam":
            if decode_kernel or vocab_kernel or fast_prefill:
                raise ValueError("mode {!r} runs the plain decode step and the exact prefill: "
                                 "decode_kernel, vocab_kernel and fast_prefill apply to "
                                 "mode='beam' only".format(mode))
            if mode == "trie" and trie is None:
                raise ValueError("mode='trie' needs a TokenTrie (decode.trie.build_vocab_trie)")
        visual, ctx_valid = self.build_memory(images, context_tokens, context_lengths,
                                              dtype=dtype, flash=flash)
        if ctx_valid is not None:
            if memory_valid is not None:
                raise ValueError("pass text context or memory_valid, not both")
            memory_valid = ctx_valid
        bsz = visual.shape[0]
        strip = prefix_tokens is not None
        if prefix_tokens is None:
            prefix_tokens = torch.full((bsz, 1), sos_id, dtype=torch.long,
                                       device=visual.device)
        if num_return_sequences > 1:
            visual = visual.repeat_interleave(num_return_sequences, dim=0)
            prefix_tokens = prefix_tokens.repeat_interleave(num_return_sequences, dim=0)
            if memory_valid is not None:
                memory_valid = memory_valid.repeat_interleave(num_return_sequences, dim=0)
        tp = prefix_tokens.shape[1] if strip else 0
        if mode != "beam":
            max_steps = max_steps or 40
            with profiling.span("model.prefill", device=visual.is_cuda, chain=True,
                                tokens=visual.shape[1] + prefix_tokens.shape[1]):
                logits, cache = self.prefill(visual, prefix_tokens, max_steps, memory_valid,
                                             dtype, flash=flash)

            run = self._search_run(visual, eager_loop, (mode, max_steps, dtype))

            def plain_step(tokens, cache):
                return self.decode_step(tokens, cache, dtype, graph=run is not None)

            if mode == "greedy":
                seqs, logprobs = greedy_search(plain_step, logits, cache, prefix_tokens, max_steps,
                                               run=run)
            else:
                seqs, logprobs = trie_greedy_search(plain_step, logits, cache, prefix_tokens,
                                                    trie, max_steps, run=run)
            return seqs[:, tp:], logprobs
        beam = beam or BeamSearchConfig()
        with profiling.span("model.prefill", device=visual.is_cuda, chain=True,
                            tokens=visual.shape[1] + prefix_tokens.shape[1]):
            logits, cache = self.prefill(visual, prefix_tokens, beam.max_steps,
                                         memory_valid, dtype, fast=fast_prefill,
                                         kernel_memory=decode_kernel, flash=flash)

        vocab_kernel = bool(vocab_kernel) and self.vocab_kernel_applies(beam)
        run = self._search_run(visual, eager_loop, ("beam", beam, dtype, decode_kernel,
                                                    vocab_kernel))

        def step(tokens, cache):
            return self.decode_step(tokens, cache, dtype, kernel=bool(decode_kernel),
                                    vocab_kernel=vocab_kernel, graph=run is not None)

        decoded, logprobs = beam_search(step, logits, cache, prefix_tokens, beam, rng=rng,
                                        vocab_stats=vocab_kernel, run=run)
        decoded = decoded[:, :, tp:]
        if beam.num_keep_best == 1:
            decoded, logprobs = decoded[:, 0], logprobs[:, 0]
        return decoded, logprobs

    def _search_run(self, visual, eager_loop, key):
        """The search's loop: None, the eager loop, for CPU tensors, a
        gloo model group or eager_loop=True; else `device_loop.run` with
        this model as the owner of its graphs and `key` (what fixes the
        step's code beside the state's shapes).

        On an NCCL model group the step's all-reduces go over the mesh's
        graph group (`decode_step(graph=True)`, `Mesh.graph_group`: a
        communicator that no eager collective shares, as NCCL's graph
        mixing off requires), and the key names that group
        (`comm.group_key`), so that one model sharded for two meshes
        never shares a graph.  The ranks of a group stay in lockstep with
        nothing exchanged for it: each calls generate with the same
        inputs and settings, so each misses the cache, warms up (the
        warm-up step runs the graph group's collectives, which also makes
        its communicator) and captures at the same call; and each rank's
        predicate is computed from values that are equal bit for bit on
        every rank (logits of the replicated head over all-reduced
        activations, the same flags and lengths, a sampled search's noise
        from the group's rank-0 generator state, `share_generator`), so
        every rank takes the same branch of the IF node at every launch
        and the all-reduces inside the step pair up."""
        group = self.textual.tp_group
        if eager_loop or not visual.is_cuda or not comm.capturable(group):
            return None
        if group is not None:
            if self.textual.graph_group is None:
                raise RuntimeError("an NCCL model group without its graph group: shard the "
                                   "model on a mesh from parallel.mesh.make_mesh")
            key = key + (comm.group_key(self.textual.graph_group),)

        def run(state, step, running, result, replays, draw=None, rng=None):
            return device_loop.run(self, key, state, step, running, result, replays, draw, rng)

        return run


def share_generator(rng: torch.Generator, mesh):
    """Give `rng` the state of its model group's rank 0 on every rank of
    the group: `rng.get_state()` broadcast over `mesh.model_group`, as
    bytes on the mesh's device (NCCL takes CUDA tensors only).  Returns
    rng."""
    from ..parallel import comm

    state = rng.get_state()
    src = mesh.base + mesh.data_rank * mesh.model  # the group's rank 0, globally
    t = comm.broadcast(state.to(mesh.device), src, mesh.model_group)
    rng.set_state(t.cpu())
    return rng


def eos_gate_params(words, positions, eos_id=102, gate=12):
    """numpy [V, D] word table -> a copy whose EOS row points along the
    late-position direction of the positional table [P, D].  Through the
    tied head this suppresses EOS before position `gate` and makes it
    dominant after, so random weights decode ~gate-token captions and
    the search's is_done early exit fires (gitax bench.py:95-113)."""
    words = np.array(words, np.float32)
    pos = np.asarray(positions, np.float32)
    d = pos[gate:gate + 8].mean(0) - pos[:gate].mean(0)
    words[eos_id] = 10.0 * d / np.linalg.norm(d)
    return words


@torch.no_grad()
def eos_gate_(model: GitModel, eos_id=102, gate=12):
    """Apply `eos_gate_params` to a model's word table in place."""
    emb = model.textual.embedding
    words = eos_gate_params(emb.words.weight.float().cpu().numpy(),
                            emb.positions.weight.float().cpu().numpy(), eos_id, gate)
    emb.words.weight.copy_(torch.from_numpy(words))
    return model
