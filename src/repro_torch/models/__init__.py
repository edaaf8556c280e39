"""The LM stack: config, layers, attention, the transformer blocks and the
model's entry points (``forward``, ``prefill``, ``decode_step``).  This
slice holds the dense attention families; MoE, RWKV, Griffin, the encoder
and the frontends raise ``NotImplementedError``."""
