"""Torch dataset bridges (reference: ``daft_tpu/to_torch.py``, after
``daft/dataframe/to_torch.py``): a map-style dataset over the collected
rows, and an iterable one that streams ``DataFrame.iter_rows``.

Both are ``torch.utils.data`` datasets themselves, so a ``DataLoader``
takes them as they are (the reference's wrappers hold a dataset in
``_ds`` and are not one).
"""

from __future__ import annotations

import torch.utils.data


class TorchMapDataset(torch.utils.data.Dataset):
    def __init__(self, df):
        self._rows = df.to_pylist()

    def __len__(self):
        return len(self._rows)

    def __getitem__(self, i):
        return self._rows[i]


class TorchIterDataset(torch.utils.data.IterableDataset):
    def __init__(self, df):
        self._df = df

    def __iter__(self):
        return self._df.iter_rows()
