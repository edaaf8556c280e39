"""The chain interpreter as one kernel: every row of a batched VMState run
to its own stop (the plain version is the machine's host loop)."""
