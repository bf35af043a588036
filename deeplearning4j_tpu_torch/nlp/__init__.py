"""NLP: Word2Vec trained as CBOW with negative sampling on the device.

- ``text``          tokenizers and sentence iterators
- ``vocab``         VocabCache/VocabConstructor, unigram table, subsampling
- ``lookup_table``  InMemoryLookupTable (syn0/syn1neg, numpy between fits)
- ``word2vec``      SequenceVectors engine and the Word2Vec builder front

The CBOW round and the ``embedding_bag`` kernel it launches live in
``ops/embeddings.py``.
"""

from .lookup_table import InMemoryLookupTable
from .text import (CollectionSentenceIterator, CommonPreprocessor,
                   DefaultTokenizerFactory, LineSentenceIterator,
                   LowCasePreProcessor, SentenceIterator, Tokenizer,
                   TokenizerFactory, TokenPreProcess)
from .vocab import (VocabCache, VocabConstructor, VocabWord, build_huffman,
                    huffman_arrays, subsample_keep_probs, unigram_int_table,
                    unigram_table)
from .word2vec import SequenceVectors, Word2Vec, WordVectors

__all__ = [
    "CollectionSentenceIterator", "CommonPreprocessor",
    "DefaultTokenizerFactory", "InMemoryLookupTable", "LineSentenceIterator",
    "LowCasePreProcessor", "SentenceIterator", "SequenceVectors",
    "TokenPreProcess", "Tokenizer", "TokenizerFactory", "VocabCache",
    "VocabConstructor", "VocabWord", "Word2Vec", "WordVectors",
    "build_huffman", "huffman_arrays", "subsample_keep_probs",
    "unigram_int_table", "unigram_table",
]
