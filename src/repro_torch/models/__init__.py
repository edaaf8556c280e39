"""The LM stack: config, layers, attention, the transformer blocks and the
model's entry points (``forward``, ``prefill``, ``decode_step``).  It
holds the dense attention families, RWKV6 (``rwkv``) and Griffin's
recurrent block (``griffin``); MoE, the encoder and the frontends raise
``NotImplementedError``."""
