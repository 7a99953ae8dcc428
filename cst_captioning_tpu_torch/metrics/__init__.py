"""Caption metrics of the port: the PTB-style tokenizer, CIDEr-D and the
consensus scores (own copies of the reference's pure-Python modules)."""
