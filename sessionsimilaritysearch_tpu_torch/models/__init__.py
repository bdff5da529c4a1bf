"""Encoder modules of the port (counterparts of ``sessionsimilaritysearch_tpu.models``,
which exports the same names; ``HGT`` and ``NodeLevelEncoder`` are not ported
yet)."""

from sessionsimilaritysearch_tpu_torch.models.embedding import (  # noqa: F401
    AveragePooling,
    NodeAsinEmbedding,
    NodeTextTransformer,
    TextEncoder,
)
from sessionsimilaritysearch_tpu_torch.models.gnn import (  # noqa: F401
    DenseGATConv,
    DenseGatedGraphConv,
    DenseGCNConv,
    DenseSAGEConv,
    HeteroGGNN,
    HeteroSAGE,
)
from sessionsimilaritysearch_tpu_torch.models.pooling import (  # noqa: F401
    AttentionPooling,
    GraphPooling,
    PositionalAttentionPooling,
    RecencySRGNNPooling,
    SRGNNPooling,
)
from sessionsimilaritysearch_tpu_torch.models.heads import (  # noqa: F401
    MLP,
    BinarizeHead,
    CrossAttentionTransformer,
    TransformerDecoderHead,
)
from sessionsimilaritysearch_tpu_torch.models.encoder import (  # noqa: F401
    GraphLevelEncoder,
    TextSessionEncoder,
    UnifyPoolingGraphLevelEncoder,
    build_graph_encoder,
    build_pretrain_encoder,
    build_text_backbone,
    build_text_session_encoder,
)
from sessionsimilaritysearch_tpu_torch.training import losses  # noqa: F401,E402
