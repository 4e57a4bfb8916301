from .fasta import PackedGenome, read_fasta, write_fai
from .sketch_tsv import write_sketch_tsv, read_sketch_tsv
