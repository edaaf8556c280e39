"""The RG-LRU linear recurrence (Griffin / RecurrentGemma)."""
