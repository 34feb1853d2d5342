"""Weight interop with the reference's Keras PointNet
(``pointcloudprocessing_tpu/export/keras_compat.py``).

Users of the TF reference (MAPieschl/PointCloudProcessing) hold trained
``.keras`` checkpoints of ``pointnet/PointNet.py:84`` models. The JAX
package walks such a live Keras object into a Flax variable tree; this
module keeps a numpy copy of that walk and composes it with the port's
converter (``convert.state_dict_from_flax``), so the result loads into the
port's models with ``load_state_dict``: :func:`state_dict_from_keras_pointnet`
into ``models.pointnet.PointNet``, :func:`state_dict_from_keras_classifier`
and :func:`state_dict_from_keras_tnet_regressor` into
``models.classifier``'s ``PointNetClassifier`` and ``TNetRegressor``.

The mapping relies only on the reference's attribute names
(``input_transform``, ``mlp_1_1`` ... ``mlp_seg_5``; TNet's
``conv_layer_N``/``dense_layer_N``/``w``/``b`` — PointNet.py:118-141,
406-416) — no TF import is required here; any object with that attribute
shape and Keras-style ``get_weights()`` works.
"""

from __future__ import annotations

import numpy as np

from pointcloudprocessing_tpu_torch.convert import state_dict_from_flax


# copied from pointcloudprocessing_tpu/export/keras_compat.py::_block_weights
def _block_weights(keras_block, is_conv: bool):
    """Extract (kernel, bias, bn_tuple) from a reference ConvLayer/DenseLayer.

    Keras ``get_weights()`` returns [kernel(, bias)] for the inner layer and
    [gamma, beta, moving_mean, moving_var] for BN. Conv2D kernels are
    (1, 1, cin, cout) — squeezed to (cin, cout) since a 1x1 conv is a
    pointwise matmul.
    """
    inner = keras_block.conv if is_conv else keras_block.dense
    weights = inner.get_weights()
    if not weights:
        raise ValueError(
            "Keras layer has no weights — the model must be built AND traced "
            "once before conversion (the reference's TNet sublayers build "
            "lazily on first call): model.build((None, n, 3)); "
            "model(tf.zeros((1, n, 3)))"
        )
    kernel = np.asarray(weights[0])
    if is_conv:
        kernel = kernel.reshape(kernel.shape[-2], kernel.shape[-1])
    bias = np.asarray(weights[1]) if len(weights) > 1 else None

    bn = None
    if getattr(keras_block, "apply_bn", False) and keras_block.bn is not None:
        gamma, beta, mean, var = [np.asarray(w) for w in keras_block.bn.get_weights()]
        bn = (gamma, beta, mean, var)
    return kernel, bias, bn


# copied from pointcloudprocessing_tpu/export/keras_compat.py::_block_to_flax
def _block_to_flax(keras_block, is_conv: bool):
    kernel, bias, bn = _block_weights(keras_block, is_conv)
    inner_name = "conv" if is_conv else "dense"
    params = {inner_name: {"kernel": np.asarray(kernel)}}
    if bias is not None:
        params[inner_name]["bias"] = np.asarray(bias)
    stats = {}
    if bn is not None:
        gamma, beta, mean, var = bn
        params["bn"] = {"scale": np.asarray(gamma), "bias": np.asarray(beta)}
        stats["bn"] = {"mean": np.asarray(mean), "var": np.asarray(var)}
    return params, stats


# copied from pointcloudprocessing_tpu/export/keras_compat.py::_tnet_to_flax
def _tnet_to_flax(keras_tnet):
    params, stats = {}, {}
    for i in (1, 2, 3):
        p, s = _block_to_flax(getattr(keras_tnet, f"conv_layer_{i}"), is_conv=True)
        params[f"conv_layer_{i}"] = p
        if s:
            stats[f"conv_layer_{i}"] = s
    for i in (1, 2):
        p, s = _block_to_flax(getattr(keras_tnet, f"dense_layer_{i}"), is_conv=False)
        params[f"dense_layer_{i}"] = p
        if s:
            stats[f"dense_layer_{i}"] = s
    params["w"] = np.asarray(np.asarray(keras_tnet.w))
    params["b"] = np.asarray(np.asarray(keras_tnet.b))
    return params, stats


# copied from pointcloudprocessing_tpu/export/keras_compat.py::flax_variables_from_keras_pointnet
def flax_variables_from_keras_pointnet(keras_model, vanilla: bool = False) -> dict:
    """Convert a reference Keras ``PointNet`` into flax variables.

    Returns ``{"params": ..., "batch_stats": ...}`` shaped exactly like
    ``models.PointNet(num_classes, num_parts, vanilla=vanilla).init(...)``.
    """
    params, stats = {}, {}

    if not vanilla:
        for name in ("input_transform", "feature_transform"):
            p, s = _tnet_to_flax(getattr(keras_model, name))
            params[name] = p
            if s:
                stats[name] = s

    conv_blocks = [
        "mlp_1_1", "mlp_1_2", "mlp_2_1", "mlp_2_2", "mlp_2_3",
        "mlp_seg_1", "mlp_seg_2", "mlp_seg_3", "mlp_seg_4", "mlp_seg_5",
    ]
    for name in conv_blocks:
        p, s = _block_to_flax(getattr(keras_model, name), is_conv=True)
        params[name] = p
        if s:
            stats[name] = s

    for name in ("mlp_cls_1", "mlp_cls_2", "mlp_cls_3"):
        p, s = _block_to_flax(getattr(keras_model, name), is_conv=False)
        params[name] = p
        if s:
            stats[name] = s

    return {"params": params, "batch_stats": stats}


# copied from pointcloudprocessing_tpu/export/keras_compat.py::flax_variables_from_keras_classifier
def flax_variables_from_keras_classifier(keras_model) -> dict:
    """Convert a reference legacy Keras ``PointNetClassifier``
    (``pointnet/PointNetClassifier.py:85``) into flax variables shaped like
    ``models.classifier.PointNetClassifier(num_classes).init(...)``.

    The legacy conventions differ from the current model and are carried by
    the module structure itself: T-Net convs without BN/activation (so their
    Keras weights are ``[kernel, bias]`` — PointNetClassifier.py:283-285),
    zero-initialized transform ``w`` (:292), and no input normalization.
    ``padding='valid'`` (:349) is numerically identical to ``'same'`` for a
    (1, 1) kernel, so no mapping difference arises from it.
    """
    params, stats = {}, {}
    for name in ("input_transform", "feature_transform"):
        p, s = _tnet_to_flax(getattr(keras_model, name))
        params[name] = p
        if s:
            stats[name] = s
    for name in ("mlp_1_1", "mlp_1_2", "mlp_2_1", "mlp_2_2", "mlp_2_3"):
        p, s = _block_to_flax(getattr(keras_model, name), is_conv=True)
        params[name] = p
        if s:
            stats[name] = s
    for name in ("dense_1", "dense_2", "dense_out"):
        p, s = _block_to_flax(getattr(keras_model, name), is_conv=False)
        params[name] = p
        if s:
            stats[name] = s
    return {"params": params, "batch_stats": stats}


# copied from pointcloudprocessing_tpu/export/keras_compat.py::flax_variables_from_keras_tnet_regressor
def flax_variables_from_keras_tnet_regressor(keras_model) -> dict:
    """Convert a reference Keras ``TNetRegressor``
    (``pointnet/PointNetClassifier.py:188``) into flax variables shaped like
    ``models.classifier.TNetRegressor().init(...)``."""
    p, s = _tnet_to_flax(keras_model.input_transform)
    variables = {"params": {"input_transform": p}, "batch_stats": {}}
    if s:
        variables["batch_stats"]["input_transform"] = s
    return variables


def state_dict_from_keras_pointnet(keras_model, vanilla: bool = False) -> dict:
    """A reference Keras ``PointNet`` as a state_dict for the port's
    ``PointNet(num_classes, num_parts, vanilla=vanilla)``."""
    return state_dict_from_flax(
        flax_variables_from_keras_pointnet(keras_model, vanilla))


def state_dict_from_keras_classifier(keras_model) -> dict:
    """A reference legacy Keras ``PointNetClassifier`` as a state_dict for
    the port's ``models.classifier.PointNetClassifier``."""
    return state_dict_from_flax(flax_variables_from_keras_classifier(keras_model))


def state_dict_from_keras_tnet_regressor(keras_model) -> dict:
    """A reference Keras ``TNetRegressor`` as a state_dict for the port's
    ``models.classifier.TNetRegressor``."""
    return state_dict_from_flax(
        flax_variables_from_keras_tnet_regressor(keras_model))
