"""Distribution, as far as one card needs it: gradient compression with
error feedback, and the checkpoint/restart controller."""
