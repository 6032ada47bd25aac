"""Data layer of the port: what the text pretraining CLI reads its corpus
through (the mmap token dataset, the dictionary and the checkpointable
stream iterators), in numpy. Streams are bit-identical to
unilm_tpu.data's on the same corpus and seed, and the on-disk format is
the same, so a corpus binarized for either package trains both."""
