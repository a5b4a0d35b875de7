"""HGICodec — the end-to-end codec.

Counterpart of ``rustyhgi_tpu/models/codec.py`` (reference:
src/encoder.rs:18-71, src/decoder.rs:14-46).  A codec is its
configuration plus its quantizer's table: it has no weights.  Device
compute runs on one of two bit-identical engines:

* ``backend="auto"`` (the default) runs the CUDA kernels
  (:mod:`..ops.cuda_codec`) on a CUDA device and the plain PyTorch version
  (:mod:`..ops.pyramid`) on the CPU;
* ``backend="cuda"`` demands the kernels, and raises on a CPU device;
* ``backend="torch"`` forces the plain version on either device, as a
  baseline.

``device`` defaults to ``"cuda"``, and a machine without CUDA raises
unless the caller asked for ``device="cpu"`` by name: no silent fallback.
The container stage (:mod:`..utils.container`) runs on the host.

Two layouts of the residuals reach the device: the row-major grid
(:meth:`HGICodec.encode_plane`, :meth:`HGICodec.decode_plane`, kernels K1
and K2) and the subband layout of the ``.thgi`` container
(:meth:`HGICodec.encode_subbands`, :meth:`HGICodec.assemble_grid`,
:meth:`HGICodec.decode_subbands` and :meth:`HGICodec.decode_preview`,
kernels K3, K4 and K5).  :meth:`HGICodec.write_fast` and
:meth:`HGICodec.write_fast_batch` also entropy-code on the device: K1's
grid goes straight into the device rANS (X1), and only coded bytes cross
to the host.

Serving: :meth:`HGICodec.compile` warms the kernels up for given shapes,
and :meth:`HGICodec.export_encoder` / :meth:`HGICodec.export_decoder`
ship K1 / K2 as ``torch.export`` programs (the ``rustyhgi::`` operators
of :mod:`..ops.library`) that :func:`load_exported` loads.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops import _build, cuda_codec, library, pyramid, tpurans
from ..ops.predictors import check_predictor, predictor_name_for_tag, predictor_tag
from ..ops.quantizers import (
    QuantizationLevel,
    linear_error,
    linear_table,
    quantize_fn,
)
from ..utils.container import Archive, Metadata, frame_rans_tpu, write_archive, write_thgi
from ..utils.profiling import codec_metrics, span

__all__ = ["HGICodec", "CodecMetrics", "load_exported"]

_BACKENDS = ("auto", "cuda", "torch")


def load_exported(blob: bytes):
    """Load a serialized codec stage (see :meth:`HGICodec.export_encoder`).

    Returns the program as a callable module: ``enc(image)`` gives
    ``(grid, recon)``, ``dec(grid)`` the image, on the device it was
    exported on, through the ``rustyhgi::`` operators.
    """
    return torch.export.load(io.BytesIO(blob)).module()


class _Encoder(torch.nn.Module):
    """K1 at one depth, predictor and table, for ``torch.export``."""

    def __init__(self, levels: int, predictor: str, table: Optional[torch.Tensor]):
        super().__init__()
        self.levels, self.predictor, self.lossless = levels, predictor, table is None
        table = torch.zeros(256, dtype=torch.uint8) if table is None else table.to(torch.uint8)
        self.register_buffer("table", table)

    def forward(self, image: torch.Tensor):
        return library.encode_plane(image, self.table, self.levels, self.predictor, self.lossless)


class _Decoder(torch.nn.Module):
    """K2 at one depth and predictor, for ``torch.export``."""

    def __init__(self, levels: int, predictor: str):
        super().__init__()
        self.levels, self.predictor = levels, predictor

    def forward(self, grid: torch.Tensor):
        return library.decode_plane(grid, self.levels, self.predictor)


class CodecMetrics(dict):
    """Metrics produced by :meth:`HGICodec.test` (mirrors main.rs:105-111)."""

    def __str__(self) -> str:  # the reference's printout format
        return (
            f"Uncompressed: {self['uncompressed'] // 1024} kb\n"
            f"Compressed:   {self['compressed'] // 1024} kb\n"
            f"Ratio:        {self['ratio']:.2f}\n"
            f"SD:           {self['sd']:.2f}"
        )


def _resolve_device(device: Union[str, torch.device], backend: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch version"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {str(dev)!r}")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend='cuda' runs the CUDA kernels and needs a CUDA device")
    return dev


class HGICodec:
    """Hierarchical Grid Interpolation codec on PyTorch.

    ``levels`` is the pyramid depth (--level, default 4) and
    ``quantization`` the quality preset (--quantizator, default medium),
    as in the reference CLI (options.rs:53-65).
    """

    def __init__(
        self,
        levels: int = 4,
        quantization: Union[QuantizationLevel, str] = QuantizationLevel.MEDIUM,
        predictor: str = "crossed",
        quantizer: str = "linear",
        backend: str = "auto",
        device: Union[str, torch.device] = "cuda",
    ):
        if isinstance(quantization, str):
            quantization = QuantizationLevel.parse(quantization)
        if not 0 <= levels <= 16:
            raise ValueError(f"levels must be in [0, 16], got {levels}")
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        self.levels = int(levels)
        self.quantization = QuantizationLevel(quantization)
        self.predictor = check_predictor(predictor)
        self.quantizer = quantizer
        self.backend = backend
        self.device = _resolve_device(device, backend)
        quant = quantize_fn(self.quantization, quantizer)
        # None selects the engines' lossless path (recon is the source).
        self._table = None if quant.identity else quant.table
        self._engine = pyramid if backend == "torch" else cuda_codec
        self._rans = tpurans.encode_plain if backend == "torch" else tpurans.encode_batch

    @classmethod
    def from_reference(
        cls,
        cfg: dict,
        table: Optional[np.ndarray] = None,
        backend: str = "auto",
        device: Union[str, torch.device] = "cuda",
    ) -> "HGICodec":
        """The port's codec computing the same bytes as a JAX ``HGICodec``.

        ``cfg`` holds that codec's ``levels``, ``quantization``,
        ``predictor`` and ``quantizer`` attributes; ``table`` is its
        ``linear_table(quantization)`` as numpy.  The table is checked
        against the preset, since the archive's quantization tag names it;
        the strategy then decides the quantizer, as in the JAX codec
        (``noop`` is the identity whatever the preset).
        """
        q = cfg["quantization"]
        quantization = QuantizationLevel.parse(q) if isinstance(q, str) else QuantizationLevel(int(q))
        if table is not None and not np.array_equal(
            np.asarray(table).astype(np.int64), linear_table(quantization).astype(np.int64)
        ):
            raise ValueError(f"table is not the {quantization.name.lower()} preset's table")
        return cls(
            cfg["levels"], quantization, cfg["predictor"],
            cfg.get("quantizer", "linear"), backend=backend, device=device,
        )

    # -- device compute path ------------------------------------------------

    def _to_device(self, x, name: str) -> torch.Tensor:
        """``x`` as a uint8 tensor on the codec's device: the span
        ``codec.h2d``, whose bytes are those handed over from a host array
        or a tensor elsewhere (0 for a tensor already there)."""
        with span("codec.h2d") as s:
            if isinstance(x, torch.Tensor):
                t = x.to(device=self.device, dtype=torch.uint8)
                s.nbytes = 0 if t.device == x.device else t.numel()
            else:
                arr = np.ascontiguousarray(x, dtype=np.uint8)
                if not arr.flags.writeable:  # torch tensors are always writable
                    arr = arr.copy()
                t = torch.from_numpy(arr).to(self.device)
                s.nbytes = t.numel()
        if t.dim() not in (2, 3):
            raise ValueError(f"{name}: expected [H, W] or [B, H, W], got {tuple(t.shape)}")
        return t.contiguous()

    def encode_plane(self, image) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 [H, W] (or [B, H, W]) image -> (residual grid, reconstruction).

        Both are uint8 tensors on the codec's device; in lossless mode the
        reconstruction is the input tensor itself.
        """
        img = self._to_device(image, "image")
        return self._engine.encode_plane(img, self.levels, self._table, self.predictor)

    def decode_plane(self, grid) -> torch.Tensor:
        """uint8 [H, W] (or [B, H, W]) residual grid -> image on the device."""
        g = self._to_device(grid, "grid")
        return self._engine.decode_plane(g, self.levels, self.predictor)

    # -- serving: warm-up and shipped programs -------------------------------

    def compile(self, *shapes: Tuple[int, int]) -> "HGICodec":
        """Warm-up for the given shapes, so that no request pays it.

        On ``cuda`` with the kernels it loads the kernel library (built at
        first use), converts the quantizer table for the kernels once, and
        runs one :meth:`encode_plane` and one :meth:`decode_plane` on zeros
        of each shape, then synchronizes; on the CPU it runs the plain
        version once a shape.  Returns self.
        """
        if self.device.type == "cuda" and self._engine is cuda_codec:
            _build.load()
            if self._table is not None:
                cuda_codec.table_arg(self._table)
        for shape in shapes:
            zero = torch.zeros(tuple(shape), dtype=torch.uint8, device=self.device)
            self.decode_plane(self.encode_plane(zero)[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _export(self, module: torch.nn.Module, shape: Tuple[int, int]) -> bytes:
        example = torch.zeros(tuple(shape), dtype=torch.uint8, device=self.device)
        program = torch.export.export(module.to(self.device), (example,))
        program.example_inputs = None  # the zeros traced with are not part of the program
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()

    def export_encoder(self, shape: Tuple[int, int]) -> bytes:
        """Serialize the shape-specialized encoder as a portable artifact.

        Returns ``torch.export`` bytes of a program that holds one
        ``rustyhgi::encode_plane`` call (K1 on ``cuda``) with this codec's
        depth, predictor and table, on this codec's device; any process
        with this package can :func:`load_exported` and call it.  Runs the
        kernels whatever the codec's ``backend``.
        """
        return self._export(_Encoder(self.levels, self.predictor, self._table), shape)

    def export_decoder(self, shape: Tuple[int, int]) -> bytes:
        """Serialize the shape-specialized decoder (see export_encoder):
        one ``rustyhgi::decode_plane`` call, K2 on ``cuda``."""
        return self._export(_Decoder(self.levels, self.predictor), shape)

    # -- subband layout -------------------------------------------------------

    def _layout_to_device(self, anchors, subbands):
        a = self._to_device(anchors, "anchors")
        return a, [tuple(self._to_device(q, "quad") for q in quads) for quads in subbands]

    def encode_subbands(self, image):
        """uint8 [H, W] (or [B, H, W]) image -> ``(anchors, subbands, recon)``.

        The subband layout: the raw ``2**L`` anchors, then per level
        (coarsest first) the ``(q01, q10, q11)`` residual quads, in the
        canvas shapes of ``utils.container.subband_shapes``; quads hold
        residuals also where their pixel lies in the canvas padding.  All
        are uint8 tensors on the codec's device; ``recon`` is as in
        :meth:`encode_plane`.
        """
        img = self._to_device(image, "image")
        return self._engine.encode_subbands(img, self.levels, self._table, self.predictor)

    def assemble_grid(self, anchors, subbands, shape) -> torch.Tensor:
        """The subband layout -> the row-major residual grid of ``shape``
        (H, W) on the device, e.g. for :func:`..utils.container.write_thgi`."""
        a, s = self._layout_to_device(anchors, subbands)
        return self._engine.assemble_grid(a, s, tuple(shape)[-2:])

    def decode_subbands(self, anchors, subbands, shape) -> torch.Tensor:
        """The subband layout -> the uint8 image of ``shape`` (H, W) on the
        device, at the codec's depth and predictor, with no grid in
        between; pairs with ``utils.container.read_thgi_subbands``."""
        a, s = self._layout_to_device(anchors, subbands)
        return self._engine.decode_subbands(
            a, s, tuple(shape)[-2:], self.levels, self.predictor
        )

    def decode_preview(self, anchors, subbands, shape, upto: int) -> torch.Tensor:
        """Progressive decode: the image sampled every ``s = 2**(L-upto)``
        pixels, ``preview[i, j] == full[i * s, j * s]``, of shape
        ``(ceil(H/s), ceil(W/s))``.  ``subbands`` needs only its first
        ``upto`` levels; pairs with ``utils.container.read_preview``."""
        a, s = self._layout_to_device(anchors, subbands)
        return self._engine.decode_preview(
            a, s, tuple(shape)[-2:], self.levels, upto, self.predictor
        )

    # -- archive path (device compute + host container) ---------------------

    def metadata_for(self, height: int, width: int) -> Metadata:
        return Metadata(
            quantization_level=self.quantization,
            interpolation=predictor_tag(self.predictor),
            width=width,
            height=height,
            scale_level=self.levels,
        )

    def encode(self, image) -> Archive:
        """Encode a uint8 [H, W] plane into an :class:`Archive`."""
        img = self._to_device(image, "image")
        if img.dim() != 2:
            raise ValueError(f"expected [H, W], got {tuple(img.shape)}")
        grid, _ = self._engine.encode_plane(img, self.levels, self._table, self.predictor)
        return Archive(self.metadata_for(*img.shape), grid.cpu().numpy())

    def decode(self, archive: Archive) -> np.ndarray:
        """Decode an :class:`Archive` back to a uint8 [H, W] plane.

        Decode needs only the grid, its shape and ``scale_level``
        (main.rs:63-71); the archive's interpolation tag picks the
        predictor, so a left_top archive decodes with left_top.  The
        codec's own backend and device run it.
        """
        pred = predictor_name_for_tag(archive.metadata.interpolation)
        g = self._to_device(archive.grid, "grid")
        out = self._engine.decode_plane(g, archive.metadata.scale_level, pred)
        return out.cpu().numpy()

    def write_fast(self, image) -> bytes:
        """The fast ``.thgi`` of a uint8 [H, W] plane: K1's grid coded by
        the device rANS, codec 7 on the row-major layout.

        The JAX writer's bytes.  A plane above ``tpurans.MAX_SYMBOLS``
        pixels, beyond the device coder's exact histogram, is written by
        ``write_thgi(..., layouts=("rowmajor",))`` with the host coders,
        as in the JAX codec: a rule of the format.
        """
        img = self._to_device(image, "image")
        if img.dim() != 2:
            raise ValueError(f"expected [H, W], got {tuple(img.shape)}")
        h, w = img.shape
        if h * w > tpurans.MAX_SYMBOLS:
            grid, _ = self._engine.encode_plane(img, self.levels, self._table, self.predictor)
            return write_thgi(
                Archive(self.metadata_for(h, w), grid.cpu().numpy()), layouts=("rowmajor",)
            )
        return self.write_fast_batch(img[None])[0]

    def write_fast_batch(self, images) -> list:
        """:meth:`write_fast` of each plane of a uint8 [B, H, W] batch.

        One K1 launch and one X1 launch code the whole batch on the
        device, each plane with its own table and streams; then two
        copies bring the coded bytes to the host: the tables, counts and
        states of every plane (a few KB each), then exactly their coded
        words.  Blob ``i`` equals ``write_fast(images[i])`` byte for byte.
        """
        imgs = self._to_device(images, "images")
        if imgs.dim() != 3:
            raise ValueError(f"expected [B, H, W], got {tuple(imgs.shape)}")
        b, h, w = imgs.shape
        if b == 0:
            return []
        n = h * w
        if n > tpurans.MAX_SYMBOLS:
            return [self.write_fast(imgs[i]) for i in range(b)]
        # The launch spans time the enqueue; the first fetch waits for both.
        with span("codec.k1_launch"):
            grid, _ = self._engine.encode_plane(imgs, self.levels, self._table, self.predictor)
        with span("codec.x1_launch"):
            freq, counts, states, stream = self._rans(grid.reshape(b, n))
        with span("codec.fetch_heads") as s:
            heads = tpurans.fetch_heads(freq, counts, states)
            s.nbytes = sum(t.numel() * t.element_size() for t in (freq, counts, states))
        with span("codec.fetch_words") as s:
            words = tpurans.fetch_words(stream, heads[1])
            s.nbytes = words.nbytes
        with span("codec.frame"):
            payloads = tpurans.frame_payloads(n, *heads, words)
            del words  # the blobs below reuse its pages instead of faulting in new ones
            return frame_rans_tpu(self.metadata_for(h, w), payloads)

    def test(self, image, fmt: str = "hgi") -> CodecMetrics:
        """Roundtrip + metrics, mirroring ``hgi test`` (main.rs:73-120).

        The distortion is decoded-vs-ORIGINAL; the decoded plane is the
        encoder's reconstruction, which equals a decode bit for bit.
        """
        img = self._to_device(image, "image")
        if img.dim() != 2:
            raise ValueError(f"expected [H, W], got {tuple(img.shape)}")
        grid, recon = self._engine.encode_plane(img, self.levels, self._table, self.predictor)
        original = img.cpu().numpy()
        decoded = recon.cpu().numpy()
        blob = write_archive(Archive(self.metadata_for(*original.shape), grid.cpu().numpy()), fmt)
        return CodecMetrics(
            **codec_metrics(original, decoded, len(blob)),
            error_bound=linear_error(self.quantization),
            decoded=decoded,
            archive_bytes=blob,
        )
