"""Window specification (reference: ``daft_tpu/window.py``, after
``daft/window.py:12`` and daft-dsl's WindowSpec/WindowFrame)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union


class Window:
    """Builder for window specs: ``Window().partition_by("a").order_by("b")``.

    Frame bounds follow the reference: ``unbounded_preceding`` /
    ``unbounded_following`` class attributes and ``rows_between`` /
    ``range_between``.
    """

    unbounded_preceding = "unbounded_preceding"
    unbounded_following = "unbounded_following"
    current_row = 0

    def __init__(self):
        self._partition_by: List = []
        self._order_by: List = []
        self._descending: List[bool] = []
        self._nulls_first: List[bool] = []
        self._frame: Optional[Tuple[str, object, object]] = None
        self._min_periods: int = 1

    def _copy(self) -> "Window":
        w = Window()
        w._partition_by = list(self._partition_by)
        w._order_by = list(self._order_by)
        w._descending = list(self._descending)
        w._nulls_first = list(self._nulls_first)
        w._frame = self._frame
        w._min_periods = self._min_periods
        return w

    def partition_by(self, *cols) -> "Window":
        w = self._copy()
        for c in cols:
            if isinstance(c, (list, tuple)):
                w._partition_by.extend(c)
            else:
                w._partition_by.append(c)
        return w

    def order_by(self, *cols, desc: Union[bool, List[bool]] = False,
                 nulls_first: Optional[Union[bool, List[bool]]] = None
                 ) -> "Window":
        w = self._copy()
        flat = []
        for c in cols:
            if isinstance(c, (list, tuple)):
                flat.extend(c)
            else:
                flat.append(c)
        descs = [desc] * len(flat) if isinstance(desc, bool) else list(desc)
        if nulls_first is None:
            nfs = list(descs)
        elif isinstance(nulls_first, bool):
            nfs = [nulls_first] * len(flat)
        else:
            nfs = list(nulls_first)
        w._order_by.extend(flat)
        w._descending.extend(descs)
        w._nulls_first.extend(nfs)
        return w

    def rows_between(self, start="unbounded_preceding",
                     end="unbounded_following",
                     min_periods: int = 1) -> "Window":
        w = self._copy()
        w._frame = ("rows", start, end, min_periods)
        w._min_periods = min_periods
        return w

    def range_between(self, start="unbounded_preceding",
                      end="unbounded_following",
                      min_periods: int = 1) -> "Window":
        w = self._copy()
        w._frame = ("range", start, end, min_periods)
        w._min_periods = min_periods
        return w

    def __repr__(self):
        # the full spec must round-trip into repr: DataFrame.with_columns
        # groups window expressions by it, so omitting a field (e.g. sort
        # direction) would silently merge distinct specs
        return (f"Window(partition_by={self._partition_by}, "
                f"order_by={self._order_by}, desc={self._descending}, "
                f"nulls_first={self._nulls_first}, frame={self._frame}, "
                f"min_periods={self._min_periods})")
