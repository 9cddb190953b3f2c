"""Progress bar abstraction (port of ``diart_tpu/progress.py``; diart's
``progress.py``).

``TQDMProgressBar`` uses tqdm when installed; ``PlainProgressBar`` is the
dependency-free fallback. ``RichProgressBar`` uses rich when installed, else
degrades to plain output. tqdm and rich are imported only when a bar is
created. The bars write to the terminal only and never touch the card.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Text

__all__ = ["ProgressBar", "PlainProgressBar", "TQDMProgressBar", "RichProgressBar"]


class ProgressBar(ABC):
    @abstractmethod
    def create(self, total: Optional[int], description: Optional[Text] = None, unit: Text = "it"):
        ...

    @abstractmethod
    def start(self): ...

    @abstractmethod
    def update(self, n: int = 1): ...

    @abstractmethod
    def write(self, text: Text): ...

    @abstractmethod
    def close(self): ...

    @property
    def default_description(self) -> Text:
        return "Streaming"


class PlainProgressBar(ProgressBar):
    """No-dependency progress reporting (quiet except writes)."""

    def __init__(self, description: Optional[Text] = None, leave: bool = True, **kwargs):
        self.description = description
        self.count = 0
        self.total = None

    def create(self, total, description=None, unit="it"):
        self.total = total
        if self.description is None:
            self.description = description

    def start(self):
        pass

    def update(self, n: int = 1):
        self.count += n

    def write(self, text: Text):
        print(text)

    def close(self):
        pass


class TQDMProgressBar(ProgressBar):
    def __init__(
        self,
        description: Optional[Text] = None,
        leave: bool = True,
        position: Optional[int] = None,
        do_close: bool = True,
    ):
        self.description = description
        self.leave = leave
        self.position = position
        self.do_close = do_close
        self.pbar = None

    def create(self, total, description=None, unit="it"):
        try:
            from tqdm import tqdm
        except ImportError:
            self.pbar = None
            return
        if self.description is None:
            self.description = description
        self.pbar = tqdm(
            desc=self.description,
            total=total,
            unit=unit,
            leave=self.leave,
            position=self.position,
        )

    def start(self):
        pass

    def update(self, n: int = 1):
        if self.pbar is not None:
            self.pbar.update(n)

    def write(self, text: Text):
        try:
            from tqdm import tqdm

            tqdm.write(text)
        except ImportError:
            print(text)

    def close(self):
        if self.pbar is not None and self.do_close:
            self.pbar.close()


class RichProgressBar(ProgressBar):
    def __init__(self, description: Optional[Text] = None, leave: bool = True):
        self.description = description
        self._impl: ProgressBar = None

    def create(self, total, description=None, unit="it"):
        try:
            import rich  # noqa: F401

            self._impl = TQDMProgressBar(self.description)
        except ImportError:
            self._impl = PlainProgressBar(self.description)
        self._impl.create(total, description, unit)

    def start(self):
        self._impl.start()

    def update(self, n: int = 1):
        self._impl.update(n)

    def write(self, text: Text):
        (self._impl or PlainProgressBar()).write(text)

    def close(self):
        if self._impl:
            self._impl.close()
