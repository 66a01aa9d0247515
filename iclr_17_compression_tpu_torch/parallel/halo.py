"""Explicit halo exchanges over a list of tiles: tiled convolutions, the
tiled Ballé-17 codec, and local transform stacks run tile by tile.

Counterpart of ``iclr_17_compression_tpu/parallel/halo.py``. An image split
along W (or H) is a list of NHWC tensors, tile ``t`` on its own device
(``mesh.py``); one process drives them all. ``halo_exchange_w`` gives each
tile the columns its kernel needs from its neighbours, copied to its device
(JAX: ``lax.ppermute`` over ICI), and each tile's output equals the
corresponding slice of the full-image op.

Correctness argument (per-conv halos, as in JAX):
- conv2d(stride s, kernel k, pad p): tile t owns input cols
  [t·Ws, (t+1)·Ws); its output cols need input cols
  [t·Ws − p, (t+1)·Ws − s − p + k − 1], i.e. a LEFT halo of p and a RIGHT
  halo of max(k−s−p, 0) columns. A tile with no neighbour gets zeros —
  exactly the zero padding the full-image conv applies there. The conv then
  runs with padding (p, 0) across the tiled axis: on the card the K2 kernel
  takes the two paddings apart (``conv_gdn(..., padding=(ph, 0))``).
- conv_transpose2d(s, k, p, op): fetching ceil((k−1)/s) columns on both
  sides and slicing the tile's transposed output at [l·s, l·s + Ws·s)
  reproduces the global output slice; missing-neighbour zeros again equal
  the full-image implicit zeros (transposed-conv padding trims output, it
  never fabricates input).
All ops between convs (GDN, quantization) are pointwise across space.
Requires each tile's extent to be a multiple of the stride. Where a halo is
wider than a neighbour tile the exchange reads on into the next one, so a
narrow tile does not break it.

Local stacks (``local_tiles``, ``stack_tiles``): a transform stack whose
every module is local along the tiled axis (convs, pixel shuffles,
pointwise ops; ``module_extent`` walks it and refuses anything else) runs
on each tile extended by O columns of real neighbour data on each side,
O ≥ the stack's receptive radius and, for a downsampling stack, a multiple
of its total stride D; the output is cropped by O·scale. It is exact: an
output column depends on inputs within the radius, so the cropped columns
never see the extended tile's own borders, and every tile starts at a
multiple of D, so the strided grids coincide. At the image's own edges the
tile is not extended, and the stack's padding is the full image's.

Each tile runs on its own replica of the model (``mesh.replicated``: the
model itself when every tile shares its device). On the card the tiled
Ballé-17 runs the port's kernels tile by tile: K2
for each conv + GDN of the analysis (and conv3), K3 for the rounding (its
symbols), K1 for each IGDN; cuDNN runs the transposed convs. The training
mesh's tile axis runs ``tiled_balle17_train`` and, for the scale
hyperprior, ``tiled_hyperprior_train`` (the same per-conv exchanges, which
carry gradients back to the neighbour's tile, on each slot's own replica);
the joint codec's ``tiled_joint_train`` runs its stacks as local stacks
and its masked context with a halo of two columns.
"""

import math
from fractions import Fraction
from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn

from ..ops.conv import _pair, conv2d, conv_transpose2d
from ..ops.kernels.conv_gdn_kernel import conv_gdn_module
from ..ops.kernels.quant_pack_kernel import quantize_pack
from ..utils.device import cudnn_deterministic, precision_on_cuda
from .mesh import replicated, split_tiles, tile_dim

Tiles = List[torch.Tensor]


def _neighbours(tiles: Sequence[torch.Tensor], i: int, n_cols: int, side: int,
                dim: int) -> Tuple[Tiles, int]:
    """Up to ``n_cols`` columns beside tile ``i`` (``side`` −1 left, +1
    right), from the nearest neighbour outward, on tile ``i``'s device:
    (the pieces in image order, the count taken)."""
    dev = tiles[i].device
    parts, need, j = [], n_cols, i + side
    while need > 0 and 0 <= j < len(tiles):
        t = tiles[j]
        k = min(need, t.shape[dim])
        piece = t.narrow(dim, t.shape[dim] - k, k) if side < 0 else t.narrow(dim, 0, k)
        parts.append(piece.to(dev))
        need -= k
        j += side
    return (parts[::-1] if side < 0 else parts), n_cols - need


def halo_exchange_w(tiles: Sequence[torch.Tensor], left: int, right: int,
                    axis="width") -> Tiles:
    """Each tile with ``left`` columns of its left neighbour and ``right`` of
    its right one appended along ``axis`` (W by default); missing neighbours
    contribute zeros."""
    dim = tile_dim(axis)
    out = []
    for i, t in enumerate(tiles):
        parts = []
        for side, n_cols in ((-1, left), (1, right)):
            got, taken = _neighbours(tiles, i, n_cols, side, dim)
            if taken < n_cols:
                shape = list(t.shape)
                shape[dim] = n_cols - taken
                zeros = t.new_zeros(shape)
                got = [zeros] + got if side < 0 else got + [zeros]
            parts.append(got)
        out.append(torch.cat(parts[0] + [t] + parts[1], dim=dim)
                   if left or right else t)
    return out


def _along(pair, dim: int) -> int:
    """The element of an (H, W) pair along tile dimension ``dim``."""
    return _pair(pair)[dim - 1]


def _across(padding, dim: int):
    """``padding`` kept across the tiled axis, 0 along it."""
    ph, pw = _pair(padding)
    return (ph, 0) if dim == 2 else (0, pw)


def _per_tile(v, n: int) -> list:
    """``v`` as a list of one value a tile: a list as it is (tile i's own,
    its replica's, so that its gradient reaches that replica), else ``v``
    for every tile."""
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def tiled_conv2d(tiles: Sequence[torch.Tensor], w, b=None, *, stride=1,
                 padding=0, axis="width") -> Tiles:
    """A conv (OIHW ``w``, ``nn.Conv2d`` semantics) over tiles: each tile's
    output is the full conv's slice. ``w`` and ``b``: one (moved to each
    tile's device) or a list, one a tile. Each tile's extent must be a
    multiple of the stride."""
    dim = tile_dim(axis)
    ws, bs = _per_tile(w, len(tiles)), _per_tile(b, len(tiles))
    k, s, p = ws[0].shape[1 + dim], _along(stride, dim), _along(padding, dim)
    halos = halo_exchange_w(tiles, p, max(k - s - p, 0), axis)
    return [conv2d(x, wi.to(x.device), None if bi is None else bi.to(x.device), stride=stride,
                   padding=_across(padding, dim)) for x, wi, bi in zip(halos, ws, bs)]


def tiled_conv_transpose2d(tiles: Sequence[torch.Tensor], w, b=None, *,
                           stride=1, padding=0, output_padding=0, axis="width") -> Tiles:
    """A transposed conv ((Cin, Cout, kh, kw) ``w``, ``nn.ConvTranspose2d``
    semantics) over tiles: each tile's output is the full op's slice. ``w``
    and ``b`` as ``tiled_conv2d``'s."""
    dim = tile_dim(axis)
    ws, bs = _per_tile(w, len(tiles)), _per_tile(b, len(tiles))
    k, s = ws[0].shape[1 + dim], _along(stride, dim)
    halo = math.ceil((k - 1) / s)
    out = []
    for t, x, wi, bi in zip(tiles, halo_exchange_w(tiles, halo, halo, axis), ws, bs):
        y = conv_transpose2d(x, wi.to(x.device), None if bi is None else bi.to(x.device),
                             stride=stride, padding=padding, output_padding=output_padding)
        out.append(y.narrow(dim, halo * s, t.shape[dim] * s).contiguous())
    return out


def tiled_conv_gdn(tiles: Sequence[torch.Tensor], convs, gdns, axis="width") -> Tiles:
    """A ``TorchConv`` (+ ``GDN``) over tiles, each tile one ``conv_gdn``
    call (K2 on the card) with padding across the tiled axis only, with
    tile i's replicas ``convs[i]`` and ``gdns[i]`` (None: no GDN); a conv
    with ``input_block`` > 1 as its blocked 3×3 stride-1 conv. K2's
    Function recomputes its backward at the same padding pair."""
    dim, conv = tile_dim(axis), convs[0]
    if getattr(conv, "input_block", 1) > 1:
        k, s, padding = 3, 1, 1
    else:
        k, s, padding = conv.kernel_size[dim - 1], conv.stride[dim - 1], conv.padding
    p = _along(padding, dim)
    halos = halo_exchange_w(tiles, p, max(k - s - p, 0), axis)
    return [conv_gdn_module(x, c, g, padding=_across(padding, dim))
            for x, c, g in zip(halos, convs, gdns)]


def tiled_deconv(tiles: Sequence[torch.Tensor], deconv, axis="width") -> Tiles:
    """A ``TorchConvTranspose`` over tiles (one module, or a list: tile
    i's replica); one with ``output_block`` > 1 as its blocked 3×3
    stride-1 conv."""
    deconvs = _per_tile(deconv, len(tiles))
    d = deconvs[0]
    if getattr(d, "output_block", 1) > 1:
        from ..ops.conv import block_deconv_weight, deconv_torch_to_hwio, hwio_to_oihw

        s = d.output_block
        ws = [hwio_to_oihw(block_deconv_weight(deconv_torch_to_hwio(m.weight), s))
              for m in deconvs]
        bs = [None if m.bias is None else m.bias.repeat(s * s) for m in deconvs]
        return tiled_conv2d(tiles, ws, bs, stride=1, padding=1, axis=axis)
    return tiled_conv_transpose2d(tiles, [m.weight for m in deconvs],
                                  [m.bias for m in deconvs], stride=d.stride,
                                  padding=d.padding, output_padding=d.output_padding,
                                  axis=axis)


def tiled_analysis17(encoders: Sequence, tiles: Sequence[torch.Tensor], axis="width") -> Tiles:
    """The Ballé-17 analysis transform over tiles, ``encoders[i]`` tile i's
    replica: three K2 calls a tile, the features before any binarizer
    (``Analysis17.features``)."""
    no_gdn = [None] * len(tiles)
    y = tiled_conv_gdn(tiles, [e.conv1 for e in encoders], [e.gdn1 for e in encoders], axis)
    y = tiled_conv_gdn(y, [e.conv2 for e in encoders], [e.gdn2 for e in encoders], axis)
    return tiled_conv_gdn(y, [e.conv3 for e in encoders], no_gdn, axis)


def round_tiles(tiles: Sequence[torch.Tensor]) -> Tiles:
    """round() of each latent tile through K3 (step 1, the file codec's
    16-bit symbols, whose dequantized output is the rounded latent)."""
    return [quantize_pack(t.contiguous(), 1.0, 32767.0, bits=16)[1] for t in tiles]


def tiled_synthesis17(decoders: Sequence, tiles: Sequence[torch.Tensor],
                      axis="width") -> Tiles:
    """The Ballé-17 synthesis transform over tiles, ``decoders[i]`` tile i's
    replica: cuDNN's transposed convs with halos, K1 for each IGDN."""
    r = [m.igdn1(t) for m, t in
         zip(decoders, tiled_deconv(tiles, [d.deconv1 for d in decoders], axis))]
    r = [m.igdn2(t) for m, t in
         zip(decoders, tiled_deconv(r, [d.deconv2 for d in decoders], axis))]
    return tiled_deconv(r, [d.deconv3 for d in decoders], axis)


def tiled_balle17_train(models: Sequence, tiles: Sequence[torch.Tensor],
                        noises: Sequence) -> List[dict]:
    """The Ballé-17 train forward over one data row's W-tiles, tile i on
    replica ``models[i]`` with noise view ``noises[i]``
    (``ops.quant.SlotNoise``): ``tiled_analysis17`` (K2 at padding (p, 0)),
    each replica's quantizer (``Balle17Compressor.quantize``: noise-round
    takes the view's part of the whole batch's draw), ``tiled_synthesis17``
    (K1 for each IGDN), and each tile's dict as the model's forward gives
    it (``Balle17Compressor.outputs``: mse and bpp of the tile, the rate
    under its replica's BitEstimator). Differentiable throughout: an
    exchange is a copy, whose gradient flows back to the neighbour's
    tile."""
    precision_on_cuda(tiles[0])
    feature = tiled_analysis17([m.Encoder for m in models], tiles)
    quantized = [m.quantize(f, True, n) for m, f, n in zip(models, feature, noises)]
    recon = tiled_synthesis17([m.Decoder for m in models], [q[0] for q in quantized])
    return [m.outputs(x, latent, r, pre)
            for m, x, (latent, pre), r in zip(models, tiles, quantized, recon)]


def _tiled_conv(tiles: Sequence[torch.Tensor], convs: Sequence) -> Tiles:
    """A ``TorchConv`` over tiles, ``convs[i]`` tile i's replica, with halos
    (``tiled_conv2d``)."""
    c = convs[0]
    return tiled_conv2d(tiles, [m.weight for m in convs], [m.bias for m in convs],
                        stride=c.stride, padding=c.padding)


def _modules(models: Sequence, name: str) -> list:
    """Each model's submodule ``name``: one a tile."""
    return [getattr(m, name) for m in models]


class TileLayers:
    """How a transform of ``models.transforms18`` (its ``transform(run,
    x)``, as ``Layers`` runs it on one device) runs over W-tiles, tile i on
    replica ``mods[i]``: a conv + GDN as one K2 call a tile at padding
    (p, 0) (``tiled_conv_gdn``), a conv or a transposed conv with halos
    (``tiled_conv2d``, ``tiled_deconv``), a GDN (K1 for an IGDN) and
    ``each``'s function tile by tile."""

    def __init__(self, mods: Sequence):
        self.mods = list(mods)

    def conv_gdn(self, x: Tiles, conv: str, gdn: str) -> Tiles:
        return tiled_conv_gdn(x, _modules(self.mods, conv), _modules(self.mods, gdn))

    def layer(self, x: Tiles, name: str) -> Tiles:
        from ..nn.layers import GDN

        layers = _modules(self.mods, name)
        if isinstance(layers[0], nn.ConvTranspose2d):
            return tiled_deconv(x, layers)
        if isinstance(layers[0], nn.Conv2d):
            return _tiled_conv(x, layers)
        if isinstance(layers[0], GDN):
            return [g(t) for g, t in zip(layers, x)]
        raise ValueError(f"{name}: {type(layers[0]).__name__} is not a layer TileLayers tiles")

    def each(self, fn, x: Tiles) -> Tiles:
        return [fn(t) for t in x]


def tiled_transform(mods: Sequence, tiles: Sequence[torch.Tensor]) -> Tiles:
    """The transform ``mods[0]`` (one of ``models.transforms18``) over
    W-tiles, ``mods[i]`` tile i's replica (``TileLayers``)."""
    return mods[0].transform(TileLayers(mods), list(tiles))


def tiled_hyperprior_train(models: Sequence, tiles: Sequence[torch.Tensor],
                           noises: Sequence) -> List[dict]:
    """The scale hyperprior's train forward (``ScaleHyperprior``) over one
    data row's W-tiles, tile i on replica ``models[i]`` with noise view
    ``noises[i]`` (``ops.quant.SlotNoise``): the model's transforms
    through ``tiled_transform`` (K2 at padding (p, 0) for the analysis'
    conv + GDN, per-conv halos, K1 for each IGDN of the synthesis), each
    replica's quantizers (``quantize_z``, then ``quantize_y`` under σ: its
    part of the whole batch's draws at the ẑ and the y grid), and each
    tile's dict as the model's forward gives it
    (``ScaleHyperprior.outputs``: the tile's rates under its replica's
    ``bitEstimator_z`` and Laplace terms).
    Differentiable throughout. Each tile's extent must be a multiple of
    64, ẑ's downsampling."""
    from ..models.hyperprior import ScaleHyperprior

    precision_on_cuda(tiles[0])
    y = tiled_transform(_modules(models, "Encoder"), tiles)
    z = tiled_transform(_modules(models, "priorEncoder"), y)
    z_hat = [m.quantize_z(t, True, n) for m, t, n in zip(models, z, noises)]
    with cudnn_deterministic():  # as ``ScaleHyperprior.sigma``
        sigma = [ScaleHyperprior.bound_sigma(t) for t in
                 tiled_transform(_modules(models, "priorDecoder"), z_hat)]
    quantized = [m.quantize_y(t, sg, True, n) for m, t, sg, n in zip(models, y, sigma, noises)]
    recon = tiled_transform(_modules(models, "Decoder"), [q[0] for q in quantized])
    return [m.outputs(x, y_hat, zh, sg, prob_y, r) for m, x, (y_hat, prob_y), zh, sg, r
            in zip(models, tiles, quantized, z_hat, sigma, recon)]


def tiled_joint_train(models: Sequence, tiles: Sequence[torch.Tensor],
                      noises: Sequence) -> List[dict]:
    """The joint-autoregressive codec's train forward
    (``JointAutoregressive``) over one data row's W-tiles, tile i on
    replica ``models[i]`` with noise view ``noises[i]``: ``g_a``, ``h_a``,
    ``h_s`` and ``g_s`` as local stacks (``stack_tiles``; K2 for the
    residual blocks' conv + (I)GDN on each tile's overlap), each replica's
    quantizers, the masked 5×5 context conv and the 1×1 entropy parameters
    on ŷ's tiles and the hyper decoder's with their halo (``local_tiles``),
    and each tile's dict as the model's forward gives it
    (``JointAutoregressive.outputs``: the tile's Gaussian and ẑ rates).
    Differentiable throughout. Each tile's extent must be a multiple of
    64, ẑ's downsampling."""
    precision_on_cuda(tiles[0])
    y = stack_tiles(_modules(models, "g_a"), tiles)
    z = stack_tiles(_modules(models, "h_a"), y)
    quantized = [m.quantize(a, b, True, n) for m, a, b, n in zip(models, y, z, noises)]
    z_hat, y_hat = [q[0] for q in quantized], [q[1] for q in quantized]
    hyper = stack_tiles(_modules(models, "h_s"), z_hat)
    m0 = models[0]
    extent = _seq([module_extent(m0.context_prediction), module_extent(m0.entropy_parameters)])
    params = local_tiles([m.context_params for m in models], [y_hat, hyper], extent)
    recon = stack_tiles(_modules(models, "g_s"), y_hat)
    return [m.outputs(x, yh, zh, p, r) for m, x, yh, zh, p, r
            in zip(models, tiles, y_hat, z_hat, params, recon)]


def refuse_binarize(model) -> None:
    """The tiled codecs serve the rounding encoder: refuse ``binarize``."""
    if model.Encoder.binarize:
        raise ValueError("the tiled Ballé-17 codec takes the rounding encoder, not binarize")


def make_tiled_balle17(mesh, axis="width") -> Callable:
    """``tiled(model, image) -> (recon tiles, latent tiles)``: the Ballé-17
    codec's forward (analysis, round, synthesis, clip) with ``image``
    (NHWC, or a list of tiles) split over ``mesh``'s tile devices along
    ``axis``, the model replicated onto them, and every conv exchanging
    explicit halos. Each tile's extent must be a multiple of 16 (of 4 in a
    model with ``io_block`` 4)."""

    def tiled(model, image):
        refuse_binarize(model)
        tiles = image if isinstance(image, (list, tuple)) else split_tiles(image, mesh, axis)
        precision_on_cuda(tiles[0])
        models = replicated(model, mesh)
        latent = round_tiles(tiled_analysis17([m.Encoder for m in models], tiles, axis))
        recon = tiled_synthesis17([m.Decoder for m in models], latent, axis)
        return [torch.clamp(r, 0.0, 1.0) for r in recon], latent

    return tiled


# ---------------------------------------------------------------------------
# Local stacks: one overlap a stack instead of one exchange a conv.
# ---------------------------------------------------------------------------

def _seq(extents) -> Tuple[Fraction, Fraction]:
    """(radius, scale) of modules applied in turn: each one's radius, in its
    own input pixels, counted in the first one's."""
    radius, scale = Fraction(0), Fraction(1)
    for r, s in extents:
        radius += r / scale
        scale *= s
    return radius, scale


def _par(*extents) -> Tuple[Fraction, Fraction]:
    """(radius, scale) of branches that read one input and are summed."""
    scales = {s for _, s in extents}
    if len(scales) != 1:
        raise ValueError(f"branches of unequal scales {scales}")
    return max(r for r, _ in extents), scales.pop()


def module_extent(m: nn.Module, dim: int = 2) -> Tuple[Fraction, Fraction]:
    """(receptive radius in input pixels, output pixels an input pixel) of a
    module along tile dimension ``dim``, for the modules the port's local
    stacks are built of; raises for any other (it may not be local)."""
    from ..models.passr import ResB, _LeakyReLU01
    from ..nn.blocks import (AttentionBlock, PixelShuffle, ResidualBlock, ResidualBlockUpsample,
                             ResidualBlockWithStride, _Act, _ResidualUnit)
    from ..nn.layers import GDN

    if isinstance(m, nn.Sequential):
        return _seq(module_extent(c, dim) for c in m)
    if isinstance(m, nn.Conv2d):
        if getattr(m, "input_block", 1) > 1:
            raise ValueError("a blocked conv is not a local stack's module")
        k, p, d, s = (v[dim - 1] for v in (m.kernel_size, m.padding, m.dilation, m.stride))
        return Fraction(max(p, (k - 1) * d - p)), Fraction(1, s)
    if isinstance(m, PixelShuffle):
        return Fraction(0), Fraction(m.r)
    if isinstance(m, (GDN, _Act, _LeakyReLU01, nn.Identity)):
        return Fraction(0), Fraction(1)
    if isinstance(m, (ResidualBlock, ResidualBlockWithStride)):
        main = _seq([module_extent(m.conv1, dim), module_extent(m.conv2, dim)])
        return main if m.skip is None else _par(main, module_extent(m.skip, dim))
    if isinstance(m, ResidualBlockUpsample):
        return _par(_seq([module_extent(m.subpel_conv, dim), module_extent(m.conv, dim)]),
                    module_extent(m.upsample, dim))
    if isinstance(m, _ResidualUnit):
        return module_extent(m.conv, dim)
    if isinstance(m, AttentionBlock):
        return _par(module_extent(m.conv_a, dim), module_extent(m.conv_b, dim))
    if isinstance(m, ResB):
        return module_extent(m.body, dim)
    raise ValueError(f"{type(m).__name__} is not known to be local along the tiled axis")


def local_tiles(fns: Sequence[Callable], inputs: Sequence[Sequence[torch.Tensor]],
                extent: Tuple[Fraction, Fraction], axis="width") -> Tiles:
    """``fns[i](*inputs)`` over each tile i (``fns[i]``: tile i's replica of
    one function local along ``axis``, with ``extent`` = (radius, scale)):
    each tile's inputs (all at one resolution) extended by the overlap of
    real neighbour data, the output cropped back (the module docstring's
    argument)."""
    dim = tile_dim(axis)
    radius, scale = extent
    stride = scale.denominator if scale < 1 else 1
    if scale < 1 and scale.numerator != 1:
        raise ValueError(f"scale {scale} is not a whole downsampling")
    overlap = -(-math.ceil(radius) // stride) * stride
    first = inputs[0]
    if any(t.shape[dim] % stride for t in first):
        raise ValueError(f"tile extents {[t.shape[dim] for t in first]} are not multiples "
                         f"of the stack's stride {stride}")
    out = []
    for i, t in enumerate(first):
        ext, taken = [], None
        for tiles in inputs:
            left, n_left = _neighbours(tiles, i, overlap, -1, dim)
            right, n_right = _neighbours(tiles, i, overlap, 1, dim)
            ext.append(torch.cat(left + [tiles[i]] + right, dim=dim))
            taken = (n_left, n_right)
        y = fns[i](*ext)
        out.append(y.narrow(dim, int(taken[0] * scale), int(t.shape[dim] * scale)).contiguous())
    return out


def stack_tiles(stacks: Sequence[nn.Module], tiles: Sequence[torch.Tensor],
                axis="width") -> Tiles:
    """A local stack (``module_extent``) over tiles, ``stacks[i]`` tile i's
    replica, one overlap a tile."""
    return local_tiles(stacks, [tiles], module_extent(stacks[0], tile_dim(axis)), axis)
