"""Model registry — the counterpart of ``kgcn_tpu/models/registry.py``.

Resolves the ``model.py`` config key (registry name or the reference's
dotted path) to a constructor.  ``gcn``, ``gin``, ``gat``,
``gcn_rxn_3layer``, ``gcn_multitask`` and ``kg_distmult`` are ported so far;
every other name the JAX package knows raises ``NotImplementedError``
pointing at ROADMAP.md.
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


def _features(info, name):
    """The node feature width; featureless (node-embedding) datasets are
    not ported for the graph-classification models."""
    if not info.feature_enabled or not info.feature_dim:
        raise NotImplementedError(
            f"{name} in node-embedding mode is not ported yet (ROADMAP.md queue A)"
        )
    return info.feature_dim


def _gcn(info, config):
    from kgcn_tpu_torch.models.standard import GCN

    return GCN(
        in_features=_features(info, "gcn"),
        channels=info.adj_channel_num,
        label_dim=info.label_dim or 2,
        dropout_rate=float(config.get("dropout_rate", 0.2)),
    )


def _common(info):
    return dict(channels=info.adj_channel_num, label_dim=info.label_dim or 2)


def _gin(info, config):
    from kgcn_tpu_torch.models.standard import GIN

    return GIN(in_features=_features(info, "gin"), **_common(info))


def _gcn_rxn_3layer(info, config):
    from kgcn_tpu_torch.models.standard import RxnGCN

    return RxnGCN(_features(info, "gcn_rxn_3layer"), **_common(info))


def _gcn_multitask(info, config):
    from kgcn_tpu_torch.models.standard import GCNMultitask

    return GCNMultitask(_features(info, "gcn_multitask"), pos_weight=info.pos_weight,
                        **_common(info))


def _gat(info, config):
    from kgcn_tpu_torch.models.standard import GATModel

    return GATModel(
        in_features=info.feature_dim,
        channels=info.adj_channel_num,
        label_dim=info.label_dim or 2,
        gat_normalize=str(config.get("gat_normalize", "sender")),
    )


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
             "kg_distmult": _kg_distmult}


def available() -> list:
    return sorted(_REGISTRY)


def build_model(name: str, info, config: Dict[str, Any]):
    """Resolve a model name (registry key or reference alias) and build the
    ``nn.Module``."""
    key = _REFERENCE_ALIASES.get(name, name)
    if key in _REGISTRY:
        return _REGISTRY[key](info, config)
    raise NotImplementedError(
        f"model '{name}' is not ported to kgcn_tpu_torch yet (available: "
        f"{available()}); see ROADMAP.md queue A for the order of the port"
    )
