"""Weights into the port: the JAX package's flax variables, or a reference
`.pth`, as the port's state dict.

The port's modules carry the reference's state-dict names, so a reference
checkpoint loads with `load_state_dict` as it is. `state_dict_from_jax`
mirrors `semi_detr_tpu/utils/torch_weights.export_dino_detector` without
importing it (the port imports nothing of the JAX package):

* Dense kernel (in, out) -> Linear weight (out, in);
* Conv kernel HWIO -> OIHW;
* flax per-head attention kernels -> `in_proj_weight` rows [q; k; v] and
  `out_proj`;
* the scanned `enc` / `dec` parameters lose their leading layer axis, one
  entry per layer;
* the shared `fc_cls` / `fc_reg` are written at every decoder index.

`projector_state_dict_from_jax` inverts the JAX package's
`convert_projector` (the SSOD Projector), and `ssod_state_dicts_from_jax`
carries a whole SSOD state: student, teacher and projector.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

RESNET50_BLOCKS = (3, 4, 6, 3)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C"))      # a writable copy


def _layer(tree, i):
    """Slice layer `i` off every leaf of a scanned (stacked) subtree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax(variables: Dict[str, Any],
                        num_decoder_layers: int = 6
                        ) -> Dict[str, torch.Tensor]:
    """JAX `DINODetector` variables (numpy leaves) -> the port's state dict
    (reference layout, float tensors on the CPU)."""
    p = variables["params"]
    stats = variables.get("batch_stats", {}).get("backbone", {})
    sd: Dict[str, torch.Tensor] = {}

    def put_conv(name, node):
        sd[name + ".weight"] = _t(np.transpose(np.asarray(node["kernel"]),
                                               (3, 2, 0, 1)))

    def put_lin(name, node):
        sd[name + ".weight"] = _t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            sd[name + ".bias"] = _t(node["bias"])

    def put_norm(name, node):
        sd[name + ".weight"] = _t(node["scale"])
        sd[name + ".bias"] = _t(node["bias"])

    def put_bn(name, pnode, snode):
        put_norm(name, pnode)
        sd[name + ".running_mean"] = _t(snode["mean"])
        sd[name + ".running_var"] = _t(snode["var"])

    def put_mlp(name, node, n):
        for j in range(n):
            put_lin(f"{name}.layers.{j}", node[f"fc{j}"])

    def put_msda(name, node):
        for k in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            put_lin(f"{name}.{k}", node[k])

    bb = p["backbone"]
    put_conv("backbone.conv1", bb["stem_conv"])
    put_bn("backbone.bn1", bb["stem_bn"], stats["stem_bn"])
    for si, n in enumerate(RESNET50_BLOCKS):
        for bi in range(n):
            src = f"layer{si + 1}_{bi}"
            if src not in bb:
                continue
            dst = f"backbone.layer{si + 1}.{bi}"
            for ci in (1, 2, 3):
                put_conv(f"{dst}.conv{ci}", bb[src][f"conv{ci}"])
                put_bn(f"{dst}.bn{ci}", bb[src][f"bn{ci}"],
                       stats[src][f"bn{ci}"])
            if "ds_conv" in bb[src]:
                put_conv(f"{dst}.downsample.0", bb[src]["ds_conv"])
                put_bn(f"{dst}.downsample.1", bb[src]["ds_bn"],
                       stats[src]["ds_bn"])

    i = 0
    while f"input_proj_{i}" in p:
        put_conv(f"bbox_head.input_proj.{i}.0", p[f"input_proj_{i}"])
        sd[f"bbox_head.input_proj.{i}.0.bias"] = _t(
            p[f"input_proj_{i}"]["bias"])
        put_norm(f"bbox_head.input_proj.{i}.1", p[f"input_proj_gn_{i}"])
        i += 1

    for li in range(num_decoder_layers):
        put_lin(f"bbox_head.fc_cls.{li}", p["fc_cls"]["cls"])
        put_mlp(f"bbox_head.fc_reg.{li}", p["fc_reg"], 3)
    put_lin("bbox_head.fc_enc_cls", p["fc_enc_cls"]["cls"])
    put_mlp("bbox_head.fc_enc_reg", p["fc_enc_reg"], 3)
    sd["bbox_head.label_enc.weight"] = _t(p["label_enc"])

    tr = p["transformer"]
    t = "bbox_head.transformer"
    sd[f"{t}.level_embed"] = _t(tr["level_embed"])
    sd[f"{t}.tgt_embed.weight"] = _t(tr["tgt_embed"])
    put_lin(f"{t}.enc_output", tr["enc_output"])
    put_norm(f"{t}.enc_output_norm", tr["enc_output_norm"])
    put_norm(f"{t}.decoder.norm", tr["decoder_norm"])
    put_mlp(f"{t}.decoder.ref_point_head", tr["ref_point_head"], 2)

    enc = tr["enc"]
    for i in range(np.asarray(enc["norm1"]["scale"]).shape[0]):
        lp = f"{t}.encoder.layers.{i}"
        node = _layer(enc, i)
        put_msda(f"{lp}.self_attn", node["self_attn"])
        for k in ("norm1", "norm2"):
            put_norm(f"{lp}.{k}", node[k])
        for k in ("linear1", "linear2"):
            put_lin(f"{lp}.{k}", node[k])
    dec = tr["dec"]["layer"]
    for i in range(np.asarray(dec["norm1"]["scale"]).shape[0]):
        lp = f"{t}.decoder.layers.{i}"
        node = _layer(dec, i)
        put_msda(f"{lp}.cross_attn", node["cross_attn"])
        mha = node["self_attn"]
        c = np.asarray(mha["out"]["bias"]).shape[0]
        sd[f"{lp}.self_attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(mha[k]["kernel"]).reshape(c, c).T
             for k in ("query", "key", "value")], 0))
        sd[f"{lp}.self_attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(mha[k]["bias"]).reshape(c)
             for k in ("query", "key", "value")], 0))
        sd[f"{lp}.self_attn.out_proj.weight"] = _t(
            np.asarray(mha["out"]["kernel"]).reshape(c, c).T)
        sd[f"{lp}.self_attn.out_proj.bias"] = _t(mha["out"]["bias"])
        for k in ("norm1", "norm2", "norm3"):
            put_norm(f"{lp}.{k}", node[k])
        for k in ("linear1", "linear2"):
            put_lin(f"{lp}.{k}", node[k])
    return sd


def projector_state_dict_from_jax(params: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """JAX `Projector` params -> the reference Projector's state dict
    (`conv1`, `bn1`, `conv2`, `bn2`, `fc1`, `bn`, `fc2`; no BN running
    statistics: the module runs on batch statistics only). fc1's input
    rows go from flax's HWC flatten back to the reference's NCHW flatten
    (c * 49 + h * 7 + w)."""
    def conv(node):
        return _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))

    k1 = np.asarray(params["fc1"]["kernel"])            # (hw*hw*c, 1024)
    c = np.asarray(params["conv2"]["kernel"]).shape[3]
    hw = int(round(np.sqrt(k1.shape[0] // c)))
    w1 = (k1.T.reshape(k1.shape[1], hw, hw, c).transpose(0, 3, 1, 2)
          .reshape(k1.shape[1], -1))
    return {
        "conv1.weight": conv(params["conv1"]),
        "bn1.weight": _t(params["bn1_scale"]),
        "bn1.bias": _t(params["bn1_bias"]),
        "conv2.weight": conv(params["conv2"]),
        "bn2.weight": _t(params["bn2_scale"]),
        "bn2.bias": _t(params["bn2_bias"]),
        "fc1.weight": _t(w1),
        "fc1.bias": _t(params["fc1"]["bias"]),
        "bn.weight": _t(params["fc_bn_scale"]),
        "bn.bias": _t(params["fc_bn_bias"]),
        "fc2.weight": _t(np.asarray(params["fc2"]["kernel"]).T),
        "fc2.bias": _t(params["fc2"]["bias"]),
    }


def ssod_state_dicts_from_jax(params: Dict[str, Any], batch_stats,
                              teacher_params: Dict[str, Any],
                              num_decoder_layers: int = 6
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX SSOD state's {"detector", "projector"} params, batch_stats and
    teacher params -> the port's state dicts: {"student", "teacher",
    "projector"}."""
    return {
        "student": state_dict_from_jax(
            {"params": params["detector"], "batch_stats": batch_stats},
            num_decoder_layers),
        "teacher": state_dict_from_jax(
            {"params": teacher_params, "batch_stats": batch_stats},
            num_decoder_layers),
        "projector": projector_state_dict_from_jax(params["projector"]),
    }


def split_teacher_student(state_dict: Dict[str, Any]
                          ) -> Tuple[Dict, Dict, Dict]:
    """Partition an SSOD-wrapper state dict into (teacher, student, rest).

    The reference's duplication rule (`dino_detr_ssod.py:953-978`): a plain
    detector checkpoint (no teacher./student. prefix) is loaded into both
    copies. `rest` holds wrapper-level keys (projector.*)."""
    has_prefix = any(k.startswith(("teacher.", "student."))
                     for k in state_dict)
    if not has_prefix:
        det = {k: v for k, v in state_dict.items()
               if not k.startswith("projector.")}
        rest = {k: v for k, v in state_dict.items()
                if k.startswith("projector.")}
        return dict(det), dict(det), rest
    teacher = {k[len("teacher."):]: v for k, v in state_dict.items()
               if k.startswith("teacher.")}
    student = {k[len("student."):]: v for k, v in state_dict.items()
               if k.startswith("student.")}
    rest = {k: v for k, v in state_dict.items()
            if not k.startswith(("teacher.", "student."))}
    return teacher, student, rest


def load_teacher_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` (detector or SSOD wrapper) -> the teacher's
    detector state dict, without BN's `num_batches_tracked` counters."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    teacher, _, _ = split_teacher_student(
        {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})
    return {k: v for k, v in teacher.items()
            if not k.endswith("num_batches_tracked")}
