"""Padded sparse document rows and the out-of-core store (counterpart of
``repro.sparse``)."""
from repro_torch.sparse.matrix import (SparseDocs, df_counts, from_dense,
                                       l1_tail, l2_normalize_rows, pad_rows,
                                       remap_terms_by_df, tf_idf, to_dense,
                                       with_df)
from repro_torch.sparse.store import (ChunkPrefetcher, DocStore,
                                      DocStoreBuilder, SubsetStore, as_store,
                                      partition_store)

__all__ = ["ChunkPrefetcher", "DocStore", "DocStoreBuilder", "SparseDocs",
           "SubsetStore", "as_store", "df_counts", "from_dense", "l1_tail",
           "l2_normalize_rows", "pad_rows", "partition_store",
           "remap_terms_by_df", "tf_idf", "to_dense", "with_df"]
