# The dense LM serving path (PyTorch port of ``repro.lm``): embed (K2), layers, model, greedy decode.
