"""Model registry — the counterpart of ``kgcn_tpu/models/registry.py``.

Resolves the ``model.py`` config key (registry name or the reference's
dotted path) to a constructor: every name ``kgcn_tpu`` registers —
``gcn``, ``gin``, ``gat``, ``gcn_rxn_3layer``, ``gcn_multitask``,
``gcn_regression``, ``gcn_node_label``, ``kg_distmult``, the multimodal
family (``gcn_multimodal``, ``gcn_vector_modal``, ``seq_cnn``; a ``task``
containing ``"regression"`` gives the first two the regression head) and
the graph VAE (``gcn_vae``, ``gcn_vae_onlylink``: the link-only variant,
its ``pos_weight`` and ``norm`` from the config, which the ``cli.gen``
engine computes from edge density instead).  The sparse and pair engines
build their models themselves (``cli/sparse.py``, ``cli/pair.py``), as in
``kgcn_tpu``.  An unknown name raises ``KeyError``.  On a featureless
dataset (``with_node_embedding``) ``gcn``,
``gcn_rxn_3layer``, ``gcn_multitask`` and ``gcn_node_label`` take their
node-embedding mode (``all_node_num`` rows of ``embedding_dim``, as
``kgcn_tpu`` passes them); ``gin``, ``gat`` and ``gcn_regression`` have
none.
"""
from __future__ import annotations

from typing import Any, Dict

# reference "model.py" values → registry names (kgcn_tpu's alias table)
_REFERENCE_ALIASES = {
    "example_model.model:GCN": "gcn",
    "example_model.model_gin:GIN": "gin",
    "example_model.model_gat:GAT": "gat",
    "example_model.model_multitask:GCN": "gcn_multitask",
    "example_model.model_node_label:GCN": "gcn_node_label",
    "example_model.model_multimodal:GCN": "gcn_multimodal",
    "example_model.model_vae:VAE": "gcn_vae",
    "example_model.model_vae_onlylink:VAE": "gcn_vae_onlylink",
    "example_model.model_multimodal_vec:GCN": "gcn_vector_modal",
    "example_model.model_multimodal_regression:GCN": "gcn_multimodal",
    "sample_kg.network_prediction.model_py.distmult:DistMult": "kg_distmult",
    "example_model.model_rxn_3layer:GCN": "gcn_rxn_3layer",
    "model": "gcn",
}


def _featured(info) -> bool:
    return bool(info.feature_enabled and info.feature_dim)


def _features(info, name):
    """The node feature width of a model without a node-embedding mode."""
    if not _featured(info):
        raise ValueError(f"{name} needs node features; it has no node-embedding "
                         "mode (in kgcn_tpu neither)")
    return info.feature_dim


def _inputs(info, config):
    """The input arguments of a model with a node-embedding mode: the
    feature width, or in embedding mode none, with the table's size."""
    if _featured(info):
        return dict(in_features=info.feature_dim)
    return dict(in_features=None, all_node_num=info.all_node_num,
                embedding_dim=int(config.get("embedding_dim", 10)))


def _gcn(info, config):
    from kgcn_tpu_torch.models.standard import GCN

    return GCN(
        channels=info.adj_channel_num,
        label_dim=info.label_dim or 2,
        dropout_rate=float(config.get("dropout_rate", 0.2)),
        **_inputs(info, config),
    )


def _common(info):
    return dict(channels=info.adj_channel_num, label_dim=info.label_dim or 2)


def _gin(info, config):
    from kgcn_tpu_torch.models.standard import GIN

    return GIN(in_features=_features(info, "gin"), **_common(info))


def _gcn_rxn_3layer(info, config):
    from kgcn_tpu_torch.models.standard import RxnGCN

    return RxnGCN(**_inputs(info, config), **_common(info))


def _gcn_multitask(info, config):
    from kgcn_tpu_torch.models.standard import GCNMultitask

    return GCNMultitask(pos_weight=info.pos_weight, **_inputs(info, config),
                        **_common(info))


def _gcn_node_label(info, config):
    from kgcn_tpu_torch.models.standard import GCNNodeLabel

    return GCNNodeLabel(**_inputs(info, config), **_common(info))


def _gcn_regression(info, config):
    from kgcn_tpu_torch.models.multimodal import GCNRegression

    return GCNRegression(
        in_features=_features(info, "gcn_regression"),
        channels=info.adj_channel_num,
        label_dim=info.label_dim or 1,
        dropout_rate=float(config.get("dropout_rate", 0.2)),
    )


def _gat(info, config):
    from kgcn_tpu_torch.models.standard import GATModel

    return GATModel(
        in_features=info.feature_dim,
        channels=info.adj_channel_num,
        label_dim=info.label_dim or 2,
        gat_normalize=str(config.get("gat_normalize", "sender")),
    )


def _multimodal_task(config) -> str:
    return "regression" if "regression" in config.get("task", "") else "classification"


def _gcn_multimodal(info, config):
    from kgcn_tpu_torch.models.multimodal import GCNMultimodal

    return GCNMultimodal(
        in_features=_features(info, "gcn_multimodal"),
        sequence_symbol_num=max(info.sequence_symbol_num, 1),
        embedding_dim=int(config.get("embedding_dim", 10)),
        task=_multimodal_task(config), **_common(info),
    )


def _gcn_vector_modal(info, config):
    from kgcn_tpu_torch.models.multimodal import GCNVectorModal

    return GCNVectorModal(
        in_features=_features(info, "gcn_vector_modal"),
        modal_dims=info.vector_modal_dim, task=_multimodal_task(config),
        **_common(info),
    )


def _seq_cnn(info, config):
    from kgcn_tpu_torch.models.multimodal import SequenceCNN

    return SequenceCNN(
        vocab_size=max(info.sequence_symbol_num, 2),
        label_dim=info.label_dim or 2,
        embedding_dim=int(config.get("embedding_dim", 10)),
    )


def _gcn_vae(info, config, **over):
    from kgcn_tpu_torch.models.vae import GCNVAE

    return GCNVAE(
        in_features=_features(info, "gcn_vae"),
        channels=info.adj_channel_num,
        feature_dim=info.feature_dim,
        latent_dim=int(config.get("latent_dim", 64)),
        **over,
    )


def _gcn_vae_onlylink(info, config):
    return _gcn_vae(info, config, link_only=True,
                    pos_weight=float(config.get("pos_weight", 1.0)),
                    norm=float(config.get("norm", 1.0)))


def _kg_distmult(info, config):
    from kgcn_tpu_torch.models.kg import KGLinkPredictor

    return KGLinkPredictor(
        all_node_num=info.all_node_num,
        embedding_dim=int(config.get("embedding_dim", 10)),
        channels=info.adj_channel_num,
        encoder=config.get("kg_encoder", "embedding"),
    )


_REGISTRY = {"gcn": _gcn, "gin": _gin, "gat": _gat,
             "gcn_rxn_3layer": _gcn_rxn_3layer, "gcn_multitask": _gcn_multitask,
             "gcn_node_label": _gcn_node_label, "gcn_regression": _gcn_regression,
             "gcn_multimodal": _gcn_multimodal, "gcn_vector_modal": _gcn_vector_modal,
             "seq_cnn": _seq_cnn, "kg_distmult": _kg_distmult,
             "gcn_vae": _gcn_vae, "gcn_vae_onlylink": _gcn_vae_onlylink}


def available() -> list:
    return sorted(_REGISTRY)


def build_model(name: str, info, config: Dict[str, Any]):
    """Resolve a model name (registry key or reference alias) and build the
    ``nn.Module``."""
    key = _REFERENCE_ALIASES.get(name, name)
    if key in _REGISTRY:
        return _REGISTRY[key](info, config)
    raise KeyError(f"unknown model '{name}'; available: {available()}")
