"""The LM stack: config, layers, attention, MoE, the transformer blocks
and the model's entry points (``forward``, ``loss_fn``, ``prefill``,
``decode_step``).  It holds every family of ``configs/archs.py``: the dense
attention families, MoE (``moe``), RWKV6 (``rwkv``), Griffin's recurrent
block (``griffin``), the encoder-decoder and the modality frontends."""
