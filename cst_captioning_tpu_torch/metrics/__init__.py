"""Caption metrics of the port: the PTB-style tokenizer, CIDEr-D, the
consensus scores and the evaluation suite (BLEU, METEOR_approx, ROUGE-L,
``language_eval``), own copies of the reference's pure-Python modules."""
