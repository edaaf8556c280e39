"""The chain VM core: ISA, cost model, interpreter, assembler, engine and
offload programs."""
