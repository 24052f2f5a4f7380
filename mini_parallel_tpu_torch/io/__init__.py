"""Host data plane: FASTQ streaming and read chunking (Python path)."""
