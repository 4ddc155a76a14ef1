"""The port's models: the language models' transformer (``transformer``)
over its layers (``layers``), the MoE layer (``moe``), Wide & Deep
(``recsys``), GIN, GatedGCN and GraphSAGE (``gnn``), MACE (``mace``) and
the parameter schema (``module``); ``convert`` carries the reference's
weights in."""
