"""Eval-forward models: CNN, BiGRU, CRNN, and weight conversion."""
