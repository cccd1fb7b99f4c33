"""Padded sparse document rows (counterpart of ``repro.sparse``)."""
from repro_torch.sparse.matrix import (SparseDocs, df_counts, from_dense,
                                       l2_normalize_rows, pad_rows,
                                       remap_terms_by_df, tf_idf, to_dense,
                                       with_df)

__all__ = ["SparseDocs", "df_counts", "from_dense", "l2_normalize_rows",
           "pad_rows", "remap_terms_by_df", "tf_idf", "to_dense", "with_df"]
