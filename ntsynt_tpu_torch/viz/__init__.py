from .formats import sort_blocks, write_sequence_lengths, write_links, write_chromosome_painting  # noqa: F401
