"""The least work of one DPT forward, stage by stage, at a configuration's
widths (``dpt``) and input size (``net_hw``), batch 1.

A stage's operations are the floating-point operations of its products
(two a multiply-add: the matrix products, the convolutions and transposed
convolutions, attention's q·kᵀ and ·v), as ``torch.utils.flop_counter``
counts them; its bytes are float32 (4 a value): each input, weight and
bias read once and each output written once. Normalisations, softmax,
GELU, the upsamplings and the residual adds count their bytes and no
operations. A stage is as coarse as one pass over its inputs allows:
attention reads q, k and v and writes its output (no score matrix), and
an activation that follows a product is folded into it. The count depends
on the shapes alone, never on how the program computes a stage.

The least time of the forward is the sum over the stages of the larger
of a stage's operations over the float32 peak and its bytes over the
memory bandwidth (``work.PEAKS``).
"""

from __future__ import annotations

from benchmark.work import PEAKS, Stage

F32 = 4


def _product(name: str, m: int, k: int, n: int, extra_in: int = 0) -> Stage:
    """(m, k) · (k, n) + bias → (m, n), ``extra_in`` values more read (a
    residual)."""
    return Stage(name, F32 * (m * k + k * n + n + m * n + extra_in), 2 * m * k * n)


def _conv(name: str, cin: int, cout: int, k: int, hw_in, hw_out, bias: bool = True,
          extra_in: int = 0) -> Stage:
    """A k×k convolution (cin → cout) from hw_in to hw_out."""
    n_in, n_out = hw_in[0] * hw_in[1], hw_out[0] * hw_out[1]
    values = cin * n_in + cout * cin * k * k + (cout if bias else 0) + cout * n_out + extra_in
    return Stage(name, F32 * values, 2 * n_out * cout * cin * k * k)


def _conv_transposed(name: str, c: int, k: int, hw_in) -> Stage:
    """A k×k transposed convolution of stride k (c → c)."""
    n_in = hw_in[0] * hw_in[1]
    return Stage(name, F32 * (c * n_in + c * c * k * k + c + c * n_in * k * k),
                 2 * n_in * c * c * k * k)


def _pass(name: str, values_in: int, values_out: int) -> Stage:
    return Stage(name, F32 * (values_in + values_out), 0)


def encoder_stages(dpt: dict, net_hw) -> list[Stage]:
    C, P, heads = dpt["embed_dim"], dpt["patch_size"], dpt["num_heads"]
    hidden = dpt["mlp_ratio"] * C
    gh, gw = net_hw[0] // P, net_hw[1] // P
    g, N = gh * gw, gh * gw + 1
    gs = dpt["img_size"] // P
    out = [
        _conv("patch embed", 3, C, P, net_hw, (gh, gw)),
        _pass("position embedding", gs * gs * C, g * C),
        _pass("tokens", g * C + C + N * C, N * C),
    ]
    for i in range(dpt["depth"]):
        out += [
            _pass(f"block {i} norm1", N * C + 2 * C, N * C),
            _product(f"block {i} qkv", N, C, 3 * C),
            Stage(f"block {i} attention", F32 * 4 * N * C, 2 * 2 * heads * N * N * (C // heads)),
            _product(f"block {i} proj", N, C, C, extra_in=N * C),
            _pass(f"block {i} norm2", N * C + 2 * C, N * C),
            _product(f"block {i} fc1", N, C, hidden),
            _product(f"block {i} fc2", N, hidden, C, extra_in=N * C),
        ]
    return out


def decoder_stages(dpt: dict, net_hw) -> list[Stage]:
    C, P, f = dpt["embed_dim"], dpt["patch_size"], dpt["features"]
    gh, gw = net_hw[0] // P, net_hw[1] // P
    g = gh * gw
    out = []
    sizes = []
    for k, o in enumerate(dpt["post_channels"]):
        out += [_product(f"readout {k}", g, 2 * C, C),
                _conv(f"project {k}", C, o, 1, (gh, gw), (gh, gw))]
        if k == 0:
            out.append(_conv_transposed("resample 0", o, 4, (gh, gw)))
            hw = (4 * gh, 4 * gw)
        elif k == 1:
            out.append(_conv_transposed("resample 1", o, 2, (gh, gw)))
            hw = (2 * gh, 2 * gw)
        elif k == 2:
            hw = (gh, gw)
        else:
            hw = (-(-gh // 2), -(-gw // 2))
            out.append(_conv("resample 3", o, o, 3, (gh, gw), hw))
        out.append(_conv(f"layer{k + 1}_rn", o, f, 3, hw, hw, bias=False))
        sizes.append(hw)
    for k in (4, 3, 2, 1):
        hw = sizes[k - 1]
        units = (1, 2) if k < 4 else (2,)
        for u in units:
            out += [_conv(f"refinenet{k} unit{u} conv1", f, f, 3, hw, hw),
                    _conv(f"refinenet{k} unit{u} conv2", f, f, 3, hw, hw,
                          extra_in=f * hw[0] * hw[1])]
        if k < 4:
            out.append(_pass(f"refinenet{k} skip add", 2 * f * hw[0] * hw[1], f * hw[0] * hw[1]))
        up = (2 * hw[0], 2 * hw[1])
        out += [_pass(f"refinenet{k} upsample", f * hw[0] * hw[1], f * up[0] * up[1]),
                _conv(f"refinenet{k} out_conv", f, f, 1, up, up)]
    half = (net_hw[0] // 2, net_hw[1] // 2)
    out += [
        _conv("head conv0", f, f // 2, 3, half, half),
        _pass("head upsample", f // 2 * half[0] * half[1], f // 2 * net_hw[0] * net_hw[1]),
        _conv("head conv2", f // 2, 32, 3, net_hw, net_hw),
        _conv("head conv4", 32, 1, 1, net_hw, net_hw),
    ]
    return out


def stages(config: dict) -> list[Stage]:
    """Every stage of one forward of a configuration's network."""
    return (encoder_stages(config["dpt"], config["net_hw"])
            + decoder_stages(config["dpt"], config["net_hw"]))


def flops(config: dict) -> float:
    """The forward's floating-point operations (its products')."""
    return float(sum(s.ops for s in stages(config)))


def least_seconds(stage_list: list[Stage], peaks: dict = PEAKS) -> float:
    """The sum over the stages of the larger of operations over the
    float32 peak and bytes over the bandwidth."""
    return sum(max(s.ops / peaks["ops_per_s"], s.bytes / peaks["hbm_bytes_per_s"])
               for s in stage_list)
