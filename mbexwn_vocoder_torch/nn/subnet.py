"""CNN sub-network builder from spec lists (F0 predictor, envelope CNN).

Counterpart of the JAX package's nn/subnet.py.  Spec grammar:
  ["L", U]            linear-interp upsampling by U
  [ks, nf]            conv kernel ks -> nf channels (+ activation)
  [ks, nf, U]         conv + sub-pixel upsampling by U (+ activation)
  [ks, nf, "L<U>"]    conv, then linear-interp upsampling by U (+ activation)
followed by a final 1x1 conv to `final_n_channels`, an optional
missing-upsampling linear interp to reach `target_ups`, and an optional
final activation.  Padding layers are SYMMETRIC, or EDGE with pad_to_valid.
The JAX package's opt-in fused tail is not ported (ROADMAP.md queue 1,
item 13).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from torch import nn

from .core import Sequential
from .layers import Activation, Conv1DUpDownSample, Conv1DWeightNorm, LinInterpLayer, Pad1d


def get_missing_upsampling_factor(target_ups, total_ups, base_name):
    up = target_ups // total_ups
    if total_ups * up != target_ups:
        raise RuntimeError(
            f"get_missing_upsampling_factor::error:: Upsampling to target upsampling factor "
            f"{target_ups} from {total_ups} is not possible for subnet {base_name}")
    return up


def _pad_layer(ks, base_name, ii, pad_to_valid):
    lo = (ks - 1) // 2 + ((ks - 1) % 2)
    hi = (ks - 1) // 2
    return Pad1d(padding_size=(lo, hi), padding_type="EDGE" if pad_to_valid else "SYMMETRIC",
                 name=base_name + f"_Pad_{ii}")


def generate_subnet_from_specs(
    specs,
    base_name: str,
    in_channels: int,
    final_n_channels: int,
    final_nks: Optional[int],
    final_activation: Optional[str],
    target_ups: Optional[int] = None,
    force_causal: bool = False,
    pad_to_valid: bool = False,
    remove_inactive_pad_layers: bool = False,
    use_prelu: bool = True,
    alpha: float = 0.2,
    **_,
) -> Tuple[Sequential, int]:
    """Returns (Sequential module, total upsampling factor)."""
    if force_causal:
        raise NotImplementedError("force_causal subnets are not ported (ROADMAP.md queue 1, item 10)")
    if not use_prelu or remove_inactive_pad_layers:
        raise NotImplementedError("leaky-ReLU subnets and remove_inactive_pad_layers are not ported "
                                  "(ROADMAP.md queue 1, item 13)")
    total_ups = 1
    layers: List[nn.Module] = []
    ch = in_channels

    def pad_active(ks):
        return ((ks - 1) // 2 + ((ks - 1) % 2)) > 0

    if specs:
        ii = 0
        for ii, spec in enumerate(specs):
            if spec[0] == "L":
                layers.append(LinInterpLayer(spec[1], num_pad_end=1, drop_last=True,
                                             name=base_name + f"_LinUpLayer_{ii}"))
                continue
            ks, nf = spec[0], spec[1]
            linear_up = False
            up = 1
            if len(spec) > 2:
                if isinstance(spec[2], str):
                    if spec[2][0] == "L":
                        linear_up = True
                    up = int(spec[2][1:])
                else:
                    up = spec[2]

            if linear_up:
                layers.append(_pad_layer(ks, base_name, ii, pad_to_valid))
                layers.append(Conv1DWeightNorm(ch, nf, ks, padding="VALID", name=base_name + f"_Layer_{ii}"))
                layers.append(LinInterpLayer(up, num_pad_end=1, drop_last=True,
                                             name=base_name + f"_LinUpLayer_{ii}"))
            elif up > 1:
                if pad_to_valid and pad_active(ks):
                    layers.append(_pad_layer(ks, base_name, ii, True))
                layers.append(Conv1DUpDownSample(ch, nf, kernel_size=ks, padding="VALID" if pad_to_valid else "SAME",
                                                 factor=up, up_sample=True, name=base_name + f"_Layer_{ii}"))
            else:
                layers.append(_pad_layer(ks, base_name, ii, pad_to_valid))
                layers.append(Conv1DWeightNorm(ch, nf, ks, padding="VALID", name=base_name + f"_Layer_{ii}"))
            ch = nf
            layers.append(Activation("prelu", alpha=alpha, channels=ch, name=base_name + f"_ActLayer_{ii}"))
            total_ups *= up

        if final_nks is not None:
            if pad_to_valid and pad_active(final_nks):
                layers.append(_pad_layer(final_nks, base_name, ii, True))
            layers.append(Conv1DWeightNorm(ch, final_n_channels, final_nks,
                                           padding="VALID" if pad_to_valid else "SAME",
                                           name=base_name + "_Layer_final"))
            if (target_ups is not None) and total_ups != target_ups:
                up = get_missing_upsampling_factor(target_ups, total_ups, base_name)
                layers.append(LinInterpLayer(up, num_pad_end=1, drop_last=True, name=base_name + "_linear_interp"))
                total_ups *= up
            if layers and final_activation is not None:
                layers.append(Activation(final_activation, name=base_name + "_Layer_finalAct"))

    return Sequential(layers, name=base_name), total_ups
