"""The packed k-mer index table and its ``.npz`` format."""
